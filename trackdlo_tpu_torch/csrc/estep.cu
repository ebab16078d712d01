// Kernel S: the streamed E-step of B EM streams in one launch (B = 1 is the
// unbatched E-step).
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py fused_estep_packed_batch
// (_estep_kernel_batch) and, launched for one stream, fused_estep_packed
// (_estep_kernel): the E-step of one iteration of the per-iteration EM.
//
// What bounds it on an H100: chains of dependent steps, not bytes or FLOPs.
// One stream at M = 45 and 2048 rows is ~0.1 M exponentials over ~50 KB of
// inputs; its outputs are O(M). A point's two normalisations over the nodes
// are a chain, and one block per stream walked all rows in chunks, paying
// that chain once per chunk on one SM. The TPU streamed (m_pad, 512) tiles
// of all B streams through VMEM together.
//
// Design: one thread-block cluster per stream, C CTAs (C and each CTA's rows
// a function of n alone, so a stream gives the same bits in a batch of any
// size), the E-step of estep_cluster.cuh that kernel E runs too: compacted
// points, four lanes per point, minima and sums reduced over the cluster in
// rank order through distributed shared memory. The TPU kernel's batched
// semantics stay: with two phases and the visibility gate of ANY stream on,
// every stream sweeps its minima (else shortest_sq keeps the 1e5
// sentinel); the anchor row select reads rows up to m_pad (the TPU's zero
// pad rows) and gives 0 outside them; the gate blends p·(1 + g·(pv − 1))
// and c_plain + g·(c_vis − c_plain); the one-phase mode takes the
// visibility weights as input. CTA rank 0 of each cluster writes the
// stream's P1, PX, stats and shortest_sq. It is compiled for at most 48
// nodes and for at most 128 (estep_cluster.cuh's wide layout).
#include "estep_cluster.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;

struct EArgs {
  const float* scal;   // (B, 8): sigma2, c_plain, c_vis, gate, v_count, k_vis, tau_vis, -
  const float* y;      // (B, m, 3)
  const float* coord;  // (B, m)
  const float* nm;     // (B, m) 0/1
  const float* pv;     // (B, m) visibility weights (one-phase mode)
  const float* x;      // (B, n, 3)
  const float* xm;     // (B, n) 0/1
  int n_streams, m, n, two_phase;
  float* p1;     // (B, m)
  float* px;     // (B, m, 3)
  float* stats;  // (B, 2): Np, tr(X^T dPt1 X)
  float* short_sq;  // (B, m)
};

template <int MMAX>
__global__ void __launch_bounds__(THREADS, 1) estep_kernel(EArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& E = *reinterpret_cast<td::EstepSmem<THREADS, MMAX>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / (int)cluster.num_blocks();
  const int m = A.m, n = A.n;
  const int m_pad = (m + 7) / 8 * 8;
  const float* sc = A.scal + (size_t)s * 8;
  const float s2 = sc[0], c_plain = sc[1], c_vis = sc[2], gate = sc[3];
  bool gate_any = false;
  for (int t = 0; t < A.n_streams; ++t) gate_any = gate_any || A.scal[(size_t)t * 8 + 3] > 0.0f;
  const bool sweep = A.two_phase && gate_any;

  // Rows [m, MMAX) are zero, as the TPU's pad rows are.
  for (int k = tid; k < MMAX * 3; k += THREADS) E.y[k] = k < m * 3 ? A.y[(size_t)s * m * 3 + k] : 0.0f;
  for (int k = tid; k < MMAX; k += THREADS) {
    const bool in = k < m;
    E.coord[k] = in ? A.coord[(size_t)s * m + k] : 0.0f;
    E.nm[k] = in ? A.nm[(size_t)s * m + k] : 0.0f;
    E.pv[k] = in && !A.two_phase ? A.pv[(size_t)s * m + k] : 0.0f;
    E.gmin[k] = td::EC_BIG;
  }
  const int rows = td::ec_rows_per_cta(n);
  const int r0 = min(n, rank * rows);
  const int npts = td::ec_compact(A.x + (size_t)s * n * 3, A.xm + (size_t)s * n, r0,
                                  min(n, r0 + rows), E);  // ends in a barrier

  if (sweep) td::ec_cluster_minima(m, npts, 0, E, cluster);
  // Visibility weights from the minima (inert where the gate is off).
  if (A.two_phase) td::ec_visibility_weights(m, sc[5], sc[6], E);
  const td::EcScalars es{s2, -0.5f / s2, c_plain, c_plain + gate * (c_vis - c_plain), gate,
                         (int)sc[4], m_pad, m};
  td::ec_estep_partials<true, true>(es, npts, 1, E);
  cluster.sync();
  if (rank == 0) {
    td::ec_cluster_totals(m, 1, E, cluster);
    for (int k = tid; k < m; k += THREADS) {
      A.p1[(size_t)s * m + k] = E.tot[k];
      A.short_sq[(size_t)s * m + k] = E.gmin[k];
    }
    for (int k = tid; k < m * 3; k += THREADS) {
      const int j = k / 3, d = k - j * 3;
      A.px[(size_t)s * m * 3 + k] = E.tot[(1 + d) * m + j];
    }
    if (tid == 0) {
      A.stats[(size_t)s * 2] = E.tot[4 * m];
      A.stats[(size_t)s * 2 + 1] = E.tot[4 * m + 1];
    }
  }
  // No CTA leaves while rank 0 may still read its shared memory.
  cluster.sync();
}

// The launch configuration for B streams of n rows: B clusters of C CTAs.
template <int MMAX>
cudaError_t estep_config(int n_streams, int n, cudaLaunchConfig_t* cfg,
                         cudaLaunchAttribute* attr, cudaStream_t stream) {
  const int smem = (int)sizeof(td::EstepSmem<THREADS, MMAX>);
  cudaError_t err = cudaFuncSetAttribute(estep_kernel<MMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int c = td::ec_cluster_size(n);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n_streams * c);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int MMAX>
int launch(const EArgs& a, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = estep_config<MMAX>(a.n_streams, a.n, &cfg, &attr, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, estep_kernel<MMAX>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int trackdlo_estep(const float* scal, const float* y, const float* coord,
                              const float* nm, const float* pv, const float* x, const float* xm,
                              int n_streams, int m, int n, int two_phase, float* p1, float* px,
                              float* stats, float* short_sq, void* stream) {
  if (m < 1 || m > td::EC_MMAX_WIDE || n < 0 || n_streams < 0 ||
      td::ec_rows_per_cta(n) > td::EC_PMAX)
    return (int)cudaErrorInvalidValue;
  if (n_streams == 0) return 0;
  const EArgs a{scal, y, coord, nm, pv, x, xm, n_streams, m, n, two_phase, p1, px, stats, short_sq};
  return m <= td::EC_MMAX ? launch<td::EC_MMAX>(a, stream) : launch<td::EC_MMAX_WIDE>(a, stream);
}

// For n rows and m nodes: out[0] the cluster size, out[1] the rows per CTA,
// out[2] how many such clusters the card can hold at once, out[3] the
// shared memory of one CTA in bytes.
extern "C" int trackdlo_estep_cluster_info(int n, int m, int* out) {
  if (n < 0 || m < 1 || m > td::EC_MMAX_WIDE) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const bool narrow = m <= td::EC_MMAX;
  cudaError_t err = narrow ? estep_config<td::EC_MMAX>(1, n, &cfg, &attr, nullptr)
                           : estep_config<td::EC_MMAX_WIDE>(1, n, &cfg, &attr, nullptr);
  if (err != cudaSuccess) return (int)err;
  out[0] = td::ec_cluster_size(n);
  out[1] = td::ec_rows_per_cta(n);
  out[3] = (int)cfg.dynamicSmemBytes;
  return narrow ? (int)cudaOccupancyMaxActiveClusters(&out[2], estep_kernel<td::EC_MMAX>, &cfg)
                : (int)cudaOccupancyMaxActiveClusters(&out[2], estep_kernel<td::EC_MMAX_WIDE>,
                                                      &cfg);
}
