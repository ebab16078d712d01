"""Run the TCP tracker service on the card, or replay a recording through it.

Counterpart of trackdlo_tpu/tools/serve.py (the wire format of
:mod:`trackdlo_tpu_torch.io.net`, so either package's client or server may
be on the other end):

  python -m trackdlo_tpu_torch.tools.serve                     # serve :6571 from the card
  python -m trackdlo_tpu_torch.tools.serve --port 7000
  python -m trackdlo_tpu_torch.tools.serve --device cpu        # serve from the CPU
  python -m trackdlo_tpu_torch.tools.serve --replay seq.tdlo   # client smoke-run
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=6571)
    ap.add_argument("--device", default=None,
                    help="the tracker's device: the CUDA card unless this names the CPU")
    ap.add_argument(
        "--replay",
        metavar="SEQ.tdlo",
        help="act as a client: stream a recorded sequence to --host/--port "
        "and print per-frame results",
    )
    args = ap.parse_args(argv)

    if args.replay:
        import numpy as np

        from trackdlo_tpu_torch.io.net import TrackerClient
        from trackdlo_tpu_torch.io.raw_sequence import read_raw_sequence

        host = args.host if args.host != "0.0.0.0" else "127.0.0.1"
        with TrackerClient(host, args.port) as cli:
            for i, (rgb, depth) in enumerate(read_raw_sequence(args.replay)):
                res = cli.track(rgb, depth)
                print(
                    f"frame {i}: state={res['occlusion_state']} "
                    f"iters={res['iterations']} "
                    f"y_mean={np.asarray(res['y']).mean(0).round(4)}"
                )
        return 0

    from trackdlo_tpu_torch.io.net import TrackerServer

    srv = TrackerServer(host=args.host, port=args.port, device=args.device)
    print(f"tracker service on {srv.address[0]}:{srv.address[1]} ({srv.tracker.device})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
