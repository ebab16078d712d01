"""Dependency-free network serving: RGB-D frames in, tracked nodes out.

Counterpart of trackdlo_tpu/io/net.py, with its wire format byte for byte,
so a client of either package talks to a server of either. The server here
steps the port's ``Tracker`` (on the card, its step replayed as one CUDA
graph; every connection's state is its own, since the compiled step
returns copies out of the graph's memory).

The reference's live transport is a ROS1 topic graph (trackdlo_node.cpp:
596-626: synchronized RGB + depth subscriptions in, results_pc / markers
out). `io.ros_adapter` mirrors that for hosts with a ROS runtime; this
module is the transport for hosts WITHOUT one — a stdlib TCP server that
accepts length-delimited binary frames from any number of clients and
returns the tracked chain per frame. One tracker services all connections
(each connection is an independent stream with its own TrackerState, the
MultiTracker time-multiplexing model), so the device stays busy while
sockets idle on threads.

Wire format (little-endian), one message per frame:

  client -> server   u32 magic 'TDLN' | u8 type=1 | u16 h | u16 w |
                     u8 has_occ | rgb u8[h*w*3] | depth u16[h*w]
                     [| occ u8[h*w] ]
  server -> client   u32 magic | u8 type=129 | u16 M | u8 occlusion_state |
                     u8 converged | u32 iterations | f32 sigma2 |
                     f32 y[M*3] | u8 visible[M]

The first frame of a connection initializes the stream (skeleton init,
dlo_init.api) and returns the initialized chain with iterations=0.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading

import numpy as np

MAGIC = 0x4E4C4454  # 'TDLN'
MSG_FRAME = 1
MSG_RESULT = 129

_HDR = struct.Struct("<IBHHB")
_RES_HDR = struct.Struct("<IBHBBIf")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(
    sock: socket.socket,
    rgb: np.ndarray,
    depth: np.ndarray,
    occlusion_mask: np.ndarray | None = None,
) -> None:
    h, w = depth.shape
    sock.sendall(
        _HDR.pack(MAGIC, MSG_FRAME, h, w, int(occlusion_mask is not None))
        + np.ascontiguousarray(rgb, np.uint8).tobytes()
        + np.ascontiguousarray(depth, "<u2").tobytes()
        + (
            np.ascontiguousarray(occlusion_mask, np.uint8).tobytes()
            if occlusion_mask is not None
            else b""
        )
    )


def recv_result(sock: socket.socket) -> dict:
    magic, typ, m, occ_state, converged, iters, sigma2 = _RES_HDR.unpack(
        _recv_exact(sock, _RES_HDR.size)
    )
    if magic != MAGIC or typ != MSG_RESULT:
        raise IOError("bad result header")
    y = np.frombuffer(_recv_exact(sock, m * 12), "<f4").reshape(m, 3)
    visible = np.frombuffer(_recv_exact(sock, m), np.uint8).astype(bool)
    return {
        "y": y,
        "visible": visible,
        "occlusion_state": occ_state,
        "converged": bool(converged),
        "iterations": iters,
        "sigma2": sigma2,
    }


class TrackerClient:
    """Blocking request/response client (one stream per connection)."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port))

    def track(self, rgb, depth, occlusion_mask=None) -> dict:
        send_frame(self.sock, rgb, depth, occlusion_mask)
        return recv_result(self.sock)

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrackerServer:
    """Threaded TCP tracker service.

    ``serve_forever`` blocks; ``start`` runs it on a daemon thread and
    returns the bound (host, port) — port 0 picks a free one (tests)."""

    def __init__(self, params=None, intrinsics=None, host="0.0.0.0", port=6571, device=None):
        from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
        from trackdlo_tpu_torch.models.trackdlo import Tracker

        self.tracker = Tracker(
            params or live_params(), intrinsics or CameraIntrinsics(), device=device
        )
        # One device lock: connections are socket-concurrent but
        # device-serial (the compiled step is the shared resource; dispatch
        # order is fair via lock queuing).
        self._lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # one connection = one stream
                state = None
                while True:
                    try:
                        hdr = _recv_exact(self.request, _HDR.size)
                    except (ConnectionError, OSError):
                        return
                    magic, typ, h, w, has_occ = _HDR.unpack(hdr)
                    if magic != MAGIC or typ != MSG_FRAME:
                        return
                    rgb = np.frombuffer(
                        _recv_exact(self.request, h * w * 3), np.uint8
                    ).reshape(h, w, 3)
                    depth = np.frombuffer(
                        _recv_exact(self.request, h * w * 2), "<u2"
                    ).reshape(h, w)
                    occ = (
                        np.frombuffer(
                            _recv_exact(self.request, h * w), np.uint8
                        ).reshape(h, w)
                        if has_occ
                        else None
                    )
                    state, payload = outer._step(state, rgb, depth, occ)
                    self.request.sendall(payload)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address

    def _step(self, state, rgb, depth, occ):
        with self._lock:
            if state is None:
                state = self.tracker.init_from_frame(rgb, depth)
                y = state.y.cpu().numpy().astype(np.float32)
                m = len(y)
                payload = (
                    _RES_HDR.pack(
                        MAGIC, MSG_RESULT, m, 0, 1, 0, float(state.sigma2)
                    )
                    + y.astype("<f4").tobytes()
                    + np.ones(m, np.uint8).tobytes()
                )
                return state, payload
            state, out = self.tracker.step(state, rgb, depth, occ)
        y = out.y.cpu().numpy().astype(np.float32)
        m = len(y)
        payload = (
            _RES_HDR.pack(
                MAGIC,
                MSG_RESULT,
                m,
                int(out.occlusion_state),
                int(out.converged),
                int(out.iterations),
                float(out.sigma2),
            )
            + y.astype("<f4").tobytes()
            + out.visible_mask.cpu().numpy().astype(np.uint8).tobytes()
        )
        return state, payload

    def start(self) -> tuple[str, int]:
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self.address

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
