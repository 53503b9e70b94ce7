// Fused compact-WY right-apply with Gram and projection, for NVIDIA Hopper.
//
// Replaces the four Pallas kernels of enlsip_tpu/ops/pallas_wy.py
// (_wy_kernel, _wy_gram_kernel, _wy_gram_scale_kernel,
// _wy_gram_scale_noout_kernel) and computes the same functions of a tall
// row-major J (m, n), a WY panel V (n, k) and W = T V^T (k, n):
//
//   X   = J V                        (m, k), never leaves the chip
//   JQ1 = (J - X W) * s[:, None]     (m, n); s only in the row-scaled variants
//   G   = JQ1^T JQ1                  (n, n)
//   p   = JQ1^T rx                   (n,)
//
// One templated kernel gives all four: <GRAM, SCALE, OUT> =
// (0,0,1) the plain apply, (1,0,1) apply + Gram, (1,1,1) the same for
// J = diag(s) base, (1,1,0) Gram and projection only, JQ1 never written.
//
// Bound.  At the main shape (5,000,000 x 100, k = 50, float32) the
// function moves 2 GB in (and 2 GB out where JQ1 is written) and does
// 4 m n k + m n (n + 1) + 2 m n = 1.5e11 operations (G is symmetric, so
// the function needs only one triangle of it): about 1.2 ms of memory
// traffic against 2.3 ms of float32 FMA work at the card's published
// rates, so it is bound by operations, and the design keeps every
// product on chip and reads J exactly once.  The kernel itself
// accumulates the full square of G, twice the Gram work the function
// needs.
//
// Design.  A block owns 64 rows at a time: it stages the J tile in shared
// memory beside V and W (loaded once per block), forms X with 4 x 4
// register tiles, overwrites the tile with JQ1 (streaming it out where the
// variant has an output), and accumulates G in registers, each thread an
// interleaved 8 x 8 set of entries (i = ty + 16 a, j = tx + 16 b), so the
// shared-memory reads of a warp are conflict-free.  The TPU kernel sums G
// over a sequential grid; here blocks run concurrently, so block c walks
// row blocks c, c + P, c + 2P, ... in order, keeps its partial G and p in
// registers for the whole walk, and writes slot c of a (P, n n + n)
// workspace once; a second kernel adds the slots in index order.  P
// depends on the row count only, never on the card, and there are no
// atomics: the same inputs give the same bits on every launch.  A ragged
// last block is zero-filled in shared memory and masked on the way out.
// Products are plain FMAs of the working type (full float32 for float32
// inputs, whatever the caller's matmul precision setting is).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 thread grid
constexpr int kRB = 64;         // rows per tile: 16 thread rows x 4
constexpr int kMaxN = 128;      // Gram tiling: 16 x 8 entries a side

template <typename T, bool GRAM, bool SCALE, bool OUT>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
wy_gram_kernel(const T* __restrict__ J, const T* __restrict__ V,
               const T* __restrict__ W, const T* __restrict__ rx,
               const T* __restrict__ s, T* __restrict__ out,
               T* __restrict__ ws, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Vs = reinterpret_cast<T*>(smem_raw);   // (n, k)
  T* Ws = Vs + (size_t)n * k;               // (k, n)
  T* Jt = Ws + (size_t)n * k;               // (kRB, n): J tile, then JQ1 tile
  T* Xs = Jt + (size_t)kRB * n;             // (kRB, k)
  T* rxs = Xs + (size_t)kRB * k;            // (kRB,)
  T* ss = rxs + kRB;                        // (kRB,)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int P = gridDim.x;
  const int nblocks = (m + kRB - 1) / kRB;
  const size_t total = (size_t)m * n;

  for (int i = tid; i < n * k; i += kThreads) {
    Vs[i] = V[i];
    Ws[i] = W[i];
  }

  // Gram ownership: entries (gi[a], gj[b]); indices past n are clamped
  // (their sums are computed on a valid column and never stored).
  T acc[8][8];
  T pacc = T(0);
  int gi[8], gj[8];
  const int nt = (n + 15) / 16;             // live 16-wide groups a side
  if (GRAM) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      gi[a] = min(ty + 16 * a, n - 1);
      gj[a] = min(tx + 16 * a, n - 1);
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = T(0);
    }
  }

  for (int blk = blockIdx.x; blk < nblocks; blk += P) {
    const int r0 = blk * kRB;
    // ---- stage the tile (contiguous in row-major J), rx and s -----------
    const size_t base = (size_t)r0 * n;
    for (int i = tid; i < kRB * n; i += kThreads) {
      const size_t g = base + i;
      Jt[i] = g < total ? J[g] : T(0);
    }
    if (tid < kRB) {
      const int r = r0 + tid;
      if (GRAM) rxs[tid] = r < m ? rx[r] : T(0);
      if (SCALE) ss[tid] = r < m ? s[r] : T(0);
    }
    __syncthreads();

    // ---- X = Jt V: rows ty*4 .. +3, columns tx*4 .. +3 of each 64-chunk --
    for (int cc = 0; cc < k; cc += 64) {
      int cj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cj[j] = min(cc + tx * 4 + j, k - 1);
      T x[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[r][j] = T(0);
      for (int i = 0; i < n; ++i) {
        T a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Jt[(ty * 4 + r) * n + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Vs[i * k + cj[j]];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) x[r][j] += a[r] * b[j];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cc + tx * 4 + j;
          if (c < k) Xs[(ty * 4 + r) * k + c] = x[r][j];
        }
    }
    __syncthreads();

    // ---- JQ1 tile = (Jt - X W) * s, in place, and out to device memory ---
    for (int cc = 0; cc < n; cc += 64) {
      int cj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cj[j] = min(cc + tx * 4 + j, n - 1);
      T y[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) y[r][j] = T(0);
      for (int q = 0; q < k; ++q) {
        T a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Xs[(ty * 4 + r) * k + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Ws[q * n + cj[j]];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) y[r][j] += a[r] * b[j];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty * 4 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cc + tx * 4 + j;
          if (c < n) {
            T v = Jt[row * n + c] - y[r][j];
            if (SCALE) v *= ss[row];
            if (GRAM) Jt[row * n + c] = v;
            if (OUT && r0 + row < m) out[(size_t)(r0 + row) * n + c] = v;
          }
        }
      }
    }
    __syncthreads();

    // ---- G += JQ1t^T JQ1t, p += JQ1t^T rx, both in registers -------------
    if (GRAM) {
      for (int r = 0; r < kRB; ++r) {
        const T* row = Jt + r * n;
        T a[8], b[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (u < nt) {
            a[u] = row[gi[u]];
            b[u] = row[gj[u]];
          }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (u < nt) {
#pragma unroll
            for (int v = 0; v < 8; ++v)
              if (v < nt) acc[u][v] += a[u] * b[v];
          }
      }
      if (tid < n) {
        for (int r = 0; r < kRB; ++r) pacc += rxs[r] * Jt[r * n + tid];
      }
      __syncthreads();      // the next tile overwrites Jt
    }
  }

  if (GRAM) {
    T* slot = ws + (size_t)blockIdx.x * ((size_t)n * n + n);
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int i = ty + 16 * u, j = tx + 16 * v;
        if (i < n && j < n) slot[(size_t)i * n + j] = acc[u][v];
      }
    if (tid < n) slot[(size_t)n * n + tid] = pacc;
  }
}

// gp[e] = sum over slots c = 0 .. nparts-1, in that order, of ws[c][e].
template <typename T>
__global__ void wy_reduce_kernel(const T* __restrict__ ws, T* __restrict__ gp,
                                 int nparts, int elems) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  T sum = T(0);
  for (int c = 0; c < nparts; ++c) sum += ws[(size_t)c * elems + e];
  gp[e] = sum;
}

template <typename T, bool GRAM, bool SCALE, bool OUT>
int launch(const T* J, const T* V, const T* W, const T* rx, const T* s, T* out,
           T* ws, T* gp, int m, int n, int k, int nparts, size_t smem,
           cudaStream_t stream) {
  auto kernel = wy_gram_kernel<T, GRAM, SCALE, OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nparts, kThreads, smem, stream>>>(J, V, W, rx, s, out, ws, m, n, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (GRAM) {
    const int elems = n * n + n;
    wy_reduce_kernel<T><<<(elems + 255) / 256, 256, 0, stream>>>(ws, gp, nparts,
                                                               elems);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <typename T>
int run(const void* J, const void* V, const void* W, const void* rx,
        const void* s, void* out, void* ws, void* gp, int m, int n, int k,
        int variant, int nparts, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n > kMaxN || nparts <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)2 * n * k + (size_t)kRB * n + (size_t)kRB * k + 2 * kRB) *
      sizeof(T);
  const T* j = (const T*)J;
  const T* v = (const T*)V;
  const T* w = (const T*)W;
  const T* r = (const T*)rx;
  const T* sc = (const T*)s;
  T* o = (T*)out;
  T* wsp = (T*)ws;
  T* g = (T*)gp;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      return launch<T, false, false, true>(j, v, w, r, sc, o, wsp, g, m, n, k,
                                           nparts, smem, st);
    case 1:
      return launch<T, true, false, true>(j, v, w, r, sc, o, wsp, g, m, n, k,
                                          nparts, smem, st);
    case 2:
      return launch<T, true, true, true>(j, v, w, r, sc, o, wsp, g, m, n, k,
                                         nparts, smem, st);
    case 3:
      return launch<T, true, true, false>(j, v, w, r, sc, o, wsp, g, m, n, k,
                                          nparts, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface.  J (m, n), V (n, k), W (k, n) row-major contiguous; rx, s
// (m,) contiguous (rx unused by variant 0, s by variants 0 and 1); out
// (m, n) (unused by variant 3); ws (nparts, n n + n) scratch and gp
// (n n + n,) = [G row-major, p] (both unused by variant 0).  variant:
// 0 apply, 1 apply + Gram, 2 row-scaled apply + Gram, 3 row-scaled Gram
// without the JQ1 output.  nparts: blocks launched = partial sums kept.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns the first CUDA error (0 = success).
extern "C" int wy_gram_f32(const void* J, const void* V, const void* W,
                           const void* rx, const void* s, void* out, void* ws,
                           void* gp, int m, int n, int k, int variant,
                           int nparts, void* stream) {
  return run<float>(J, V, W, rx, s, out, ws, gp, m, n, k, variant, nparts,
                    stream);
}

extern "C" int wy_gram_f64(const void* J, const void* V, const void* W,
                           const void* rx, const void* s, void* out, void* ws,
                           void* gp, int m, int n, int k, int variant,
                           int nparts, void* stream) {
  return run<double>(J, V, W, rx, s, out, ws, gp, m, n, k, variant, nparts,
                     stream);
}

extern "C" const char* wy_gram_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
