// Nearest-neighbour argmin of scan points against a map, dense or over a
// per-tile window of map blocks ("sorted stripe").
//
// Replaces two Pallas TPU kernels of mm_masking_tpu/ops/pallas/nn_assoc.py
// whose bodies differ only in the map block they start from:
//   * _nn_argmin_pallas_fmt (body _nn_kernel): dense argmin over all M points;
//   * _nn_stripe_pallas (body _nn_stripe_kernel): each tile of scan rows
//     scans nblk[b, t] map blocks of tm points from block start_blk[b, t];
//     nblk = 0 skips the tile (the ICP's per-item freeze) and writes nothing.
// One __global__ serves both: dense is start 0 with all of M.
//
// What bounds it on this card: instruction issue. Each (scan, map) pair costs
// 8 float32 instructions that may not fuse (3 subtractions, 3 multiplies, 2
// adds, each round-to-nearest, so that d2 is bit-identical to the plain
// version's dx*dx + dy*dy + dz*dz; reduced precision picks wrong neighbours)
// plus its share of the argmin. The map is read once per unit from L2 and
// reused by every row of the unit, so the bytes are negligible: at B=32,
// N=4096, M=16384 the dense pass is 2.1e9 pairs, and 8 instructions a pair
// at 132 SMs x 128 lanes x 1.98 GHz take 0.514 ms.
//
// Design:
//  * Units of one size: (a tile of `rows` scan rows of one item, a span of
//    `span` map points). Dense: the spans cut [0, M). Stripe: they cut the
//    tile's run [start·tm, (start + nblk)·tm) ∩ [0, M), and units past the
//    run, every unit of a tile with nblk = 0 among them, leave at once. One
//    block a unit, so the block scheduler evens out the load: a block's work
//    no longer depends on how many map blocks its tile needs.
//  * Register-blocked rows: each thread holds R rows and reuses every staged
//    map point (one broadcast 16-byte shared load) across them.
//  * Chunk-min argmin: over a chunk of U map points a row keeps the fminf of
//    its distances (one FMNMX a pair; fminf drops NaN, so a NaN pair is never
//    chosen) and compares it with its running best once per chunk, keeping
//    the chunk on a strict <. At the end of the unit the row recomputes that
//    chunk's U distances (the same bits) and takes the first u that equals
//    its best: the first occurrence of the minimum within the unit.
//  * Order-free merge: d2 >= +0 and NaN never wins, so the bits of d2 order
//    as unsigned integers. A unit posts (bits(d2) << 32 | idx) for each of
//    its rows by a 64-bit atomicMin; the lexicographic minimum is the first
//    occurrence of the global minimum in whatever order the units finish, so
//    results are bitwise repeatable. The scratch starts at all ones ("none
//    found"), and a row that finds no finite distance unpacks to idx 0, d2
//    inf, as the TPU kernel gives.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// R and U were picked by timing R = 1, 2, 4, 8 and U = 4, 8, 16 at the
// eval step's shapes on the H100: more rows a thread save shared loads but
// leave fewer warps for a stripe's few live units.
constexpr int R = 2;              // scan rows a thread
constexpr int U = 8;              // map points a chunk of the argmin
constexpr int MAX_THREADS = 512;  // threads a block: tiles of up to R * 512 rows
constexpr int MAX_SPAN = 2048;    // map points a unit (32 KB of shared memory)
constexpr unsigned long long NONE = ~0ull;

__device__ __forceinline__ float sq_dist(float px, float py, float pz, float4 v) {
  const float dx = __fsub_rn(px, v.x);
  const float dy = __fsub_rn(py, v.y);
  const float dz = __fsub_rn(pz, v.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// p (B, N, 3) f32; q (B, M) float4; start_blk/nblk (B, T) int32 or null
// (dense); best (B, N) packed (d2 bits, idx), preset to NONE.
// grid = (ceil(M / span), T, B), T = ceil(N / rows); dynamic shared memory:
// span rounded up to U float4.
__global__ void __launch_bounds__(MAX_THREADS)
nn_argmin_kernel(const float* __restrict__ p, const float4* __restrict__ q,
                 const int* __restrict__ start_blk, const int* __restrict__ nblk, int N,
                 int M, int rows, int tm, int span, unsigned long long* __restrict__ best_key) {
  extern __shared__ float4 sq[];
  const int k = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int T = gridDim.y;

  int lo = 0;
  int hi = M;
  if (nblk != nullptr) {
    const int nb = nblk[b * T + t];
    if (nb <= 0) return;  // the whole block leaves before any barrier
    lo = start_blk[b * T + t] * tm;
    hi = min(M, lo + nb * tm);
  }
  const int s0 = lo + k * span;
  if (s0 >= hi) return;
  const int n = min(span, hi - s0);
  const int nc = (n + U - 1) / U;

  // Stage the unit's map points; NaN points pad the last chunk and are never
  // chosen.
  const float4* qb = q + static_cast<size_t>(b) * M + s0;
  for (int j = threadIdx.x; j < nc * U; j += blockDim.x) {
    sq[j] = j < n ? qb[j] : make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.f);
  }

  const int row0 = t * rows;
  float px[R], py[R], pz[R], best[R];
  int chunk[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = i * blockDim.x + threadIdx.x;
    px[i] = py[i] = pz[i] = 0.f;
    if (r < rows && row0 + r < N) {
      const float* pr = p + (static_cast<size_t>(b) * N + row0 + r) * 3;
      px[i] = pr[0];
      py[i] = pr[1];
      pz[i] = pr[2];
    }
    best[i] = CUDART_INF_F;
    chunk[i] = 0;
  }
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const float4* qc = sq + c * U;
    float cmin[R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 v = qc[u];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float d = sq_dist(px[i], py[i], pz[i], v);
        cmin[i] = u == 0 ? d : fminf(cmin[i], d);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (cmin[i] < best[i]) {
        best[i] = cmin[i];
        chunk[i] = c;
      }
    }
  }

  unsigned long long* out = best_key + static_cast<size_t>(b) * N + row0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = i * blockDim.x + threadIdx.x;
    if (r >= rows || row0 + r >= N || !(best[i] < CUDART_INF_F)) continue;
    const float4* qc = sq + chunk[i] * U;
    int first = 0;
#pragma unroll
    for (int u = U - 1; u >= 0; --u) {
      if (sq_dist(px[i], py[i], pz[i], qc[u]) == best[i]) first = u;
    }
    const unsigned int j = static_cast<unsigned int>(s0 + chunk[i] * U + first);
    atomicMin(out + r, (static_cast<unsigned long long>(__float_as_uint(best[i])) << 32) | j);
  }
}

// best (B·N) packed → idx, d2; NONE → (0, inf). Stripe: rows of tiles with
// nblk = 0 stay unwritten.
__global__ void nn_argmin_unpack(const unsigned long long* __restrict__ best_key,
                                 const int* __restrict__ nblk, int N, int rows, int T,
                                 int n, int* __restrict__ idx, float* __restrict__ d2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (nblk != nullptr && nblk[(i / N) * T + (i % N) / rows] <= 0) return;
  const unsigned long long key = best_key[i];
  const bool none = key == NONE;
  idx[i] = none ? 0 : static_cast<int>(key & 0xffffffffull);
  d2[i] = none ? CUDART_INF_F : __uint_as_float(static_cast<unsigned int>(key >> 32));
}

}  // namespace

// scratch: B·N 64-bit words on the stream's device (the packed minima).
extern "C" int mm_nn_argmin(const void* p, const void* q, const void* start_blk,
                            const void* nblk, int B, int N, int M, int rows, int tm, int span,
                            void* idx, void* d2, void* scratch, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int threads = ((rows + R - 1) / R + 31) / 32 * 32;
  if (rows <= 0 || threads > MAX_THREADS || span <= 0 || span > MAX_SPAN || M < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = B * N;
  auto* best = static_cast<unsigned long long*>(scratch);
  cudaError_t status = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * n, s);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int T = (N + rows - 1) / rows;
  if (M > 0) {
    const dim3 grid((M + span - 1) / span, T, B);
    const size_t smem = sizeof(float4) * ((span + U - 1) / U * U);
    nn_argmin_kernel<<<grid, threads, smem, s>>>(
        static_cast<const float*>(p), static_cast<const float4*>(q),
        static_cast<const int*>(start_blk), static_cast<const int*>(nblk), N, M, rows, tm,
        span, best);
    status = cudaGetLastError();
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  nn_argmin_unpack<<<(n + 255) / 256, 256, 0, s>>>(best, static_cast<const int*>(nblk), N,
                                                   rows, T, n, static_cast<int*>(idx),
                                                   static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}

// The text of a CUDA error code that an entry of the library returned
// (ops/kernels/_build.py::launch raises with it).
extern "C" const char* mm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
