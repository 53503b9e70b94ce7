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
// 4 m n k + m n (n + 1) + 2 m n operations (G is symmetric, so only one
// triangle of it is work): by the card's published rates the float32
// FMA work takes about twice as long as the memory traffic, so the
// function is bound by operations.  Products are plain FMAs of the
// working type (full float32 for float32 inputs, whatever the caller's
// matmul precision setting is).  With operands in shared memory, what
// limits such a kernel on this card is the shared-memory pipe: a warp's
// read costs at least one pass however many lanes share an address, and
// a 16-byte read four, so a thread's r x c register tile gets r c FMAs
// out of r + c operand words.  4 x 4 tiles starve the FMA units; the
// design below uses 8 x 4, 4 x 8 and 8 x 8.
//
// Design.
//   * A block walks 64-row units c, c + P, c + 2P, ... of J in order
//     (P blocks; P depends on the row count only, never on the card),
//     keeps its partial G and p in registers for the whole walk and
//     writes slot c of a (P, n n + n) workspace once; a second kernel
//     adds the slots in index order.  No atomics: equal inputs give
//     equal bits.
//   * The J tile, rx and s arrive by cp.async into a ring of two tiles.
//     Rows past m are zero-filled by the copy itself.  A shape whose
//     panel leaves no room for two 64-row tiles takes one 32-row tile
//     instead (same walk, two half units in order, stages in turn).
//   * Shared-memory rows are padded to four elements (and skewed off a
//     multiple of 128 bytes), so operands are read as 4-element vectors
//     and a quarter-warp's reads fall on distinct banks.  A warp is 8
//     column groups x 4 row groups.  X = tile V: 8 x 4 register tiles on
//     32-row warp tiles, kept TRANSPOSED so that the apply reads both of
//     its operands as vectors; the apply: 4 x 8 tiles, updating the tile
//     in place with vector reads and writes.
//   * G is summed over the upper triangle only, in 32 x 16 patches, one a
//     quarter-warp from the last warp down, 8 x 8 entries a thread; the
//     reduce kernel mirrors it, so G is symmetric to the bit.  At n = 100
//     the patches fill four warps and X of a 64-row tile fills the other
//     four, so with the ring of two the loop runs X of tile t + 1 in the
//     same phase as the Gram of tile t, and the copy of tile t + 2 flies
//     during the apply of tile t + 1.
//   * JQ1 leaves the chip from the finished tile in shared memory with
//     16-byte coalesced stores (where a row of J is a multiple of 16
//     bytes; element stores otherwise).
//   * The kernel below is instantiated for float32 only.  float64 has a
//     design of its own on the float64 tensor cores, in wy_gram_f64.cu,
//     which includes this file for the copies, the walk's arithmetic and
//     the reduce kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kUnit = 64;       // rows of one unit of the walk
constexpr int kMaxN = 128;      // Gram: at most 20 of the 32 quarter-warps
constexpr int kThreads = 256;   // 8 warps; float32 runs two blocks an SM
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int pad4(int x) { return (x + 3) / 4 * 4; }

// Row stride (elements) of the J tile and of W in shared memory.
__host__ __device__ inline int row_stride(int n, int itemsize) {
  int np = pad4(n);
  if ((np * itemsize) % 128 == 0) np += 4;
  return np;
}

// Shared memory in elements: V (n, kp), W (k, np), `stages` tiles
// (rb, np), X^T (k, rb), and rx and s beside every tile.
__host__ __device__ inline size_t shared_elems(int n, int k, int itemsize,
                                               int rb, int stages) {
  const size_t np = row_stride(n, itemsize), kp = pad4(k);
  return (size_t)n * kp + (size_t)k * np + (size_t)stages * rb * np +
         (size_t)k * rb + (size_t)2 * stages * rb;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&x)[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// Asynchronous copies global -> shared; `bytes` of the source are read
// and the rest of the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(bytes) : "memory");
}
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = live ? (int)sizeof(T) : 0;
  if (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src),
                 "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T (&x)[4]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

template <typename T, bool GRAM, bool SCALE, bool OUT, int RB, int NS>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
wy_gram_kernel(const T* __restrict__ J, const T* __restrict__ V,
               const T* __restrict__ W, const T* __restrict__ rx,
               const T* __restrict__ s, T* __restrict__ out,
               T* __restrict__ ws, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = row_stride(n, (int)sizeof(T));
  const int kp = pad4(k);
  T* Vs = reinterpret_cast<T*>(smem_raw);   // (n, kp), zero-padded
  T* Ws = Vs + (size_t)n * kp;              // (k, np), zero-padded
  T* tiles = Ws + (size_t)k * np;           // NS x (RB, np): J, then JQ1
  T* Xt = tiles + (size_t)NS * RB * np;     // (k, RB): X transposed
  T* rxs = Xt + (size_t)k * RB;             // NS x (RB,)
  T* ss = rxs + NS * RB;                    // NS x (RB,)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lc = lane & 7, lr = lane >> 3;  // 8 column groups x 4 row groups
  const int P = gridDim.x;
  const int nunits = (m + kUnit - 1) / kUnit;
  constexpr int H = kUnit / RB;             // tiles a unit
  constexpr int RT = RB / 32;               // 32-row warp tiles (X stage)
  constexpr int RU = RB / 16;               // 16-row warp tiles (apply)
  constexpr int kChunk = 16 / (int)sizeof(T);
  const bool vec = (n % kChunk) == 0;       // a row of J is whole 16-byte chunks
  const int cpr = n / kChunk;

  for (int i = tid; i < n * kp; i += kThreads) {
    const int r = i / kp, c = i - r * kp;
    Vs[i] = c < k ? V[r * k + c] : T(0);
  }
  for (int i = tid; i < k * np; i += kThreads) {
    const int r = i / np, c = i - r * np;
    Ws[i] = c < n ? W[r * n + c] : T(0);
  }

  // Gram ownership.  The upper triangle of G is cut into 32 x 16 patches
  // (rows pi, columns pj; those with an entry on or above the diagonal),
  // one a quarter-warp in a fixed order; a thread owns the 8 x 8 entries
  // (gi .., gj ..) of its quarter-warp's patch.  Quarter-warps past the
  // last patch (whole warps, mostly) sit the Gram stage out.
  T acc[8][8];
  T pacc = T(0);
  int gi = -1, gj = 0;
  if (GRAM) {
    const int qw = kThreads / 8 - 1 - (tid >> 3);   // from the last warp down
    int e = 0;
    for (int pj = 0; 16 * pj < n; ++pj)
      for (int pi = 0; 32 * pi < n && 32 * pi <= 16 * pj + 15; ++pi, ++e)
        if (e == qw) {
          gi = 32 * pi + 8 * (tid & 3);
          gj = 16 * pj + 8 * ((tid >> 2) & 1);
        }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = T(0);
  }

  // Tile `seq` of this block's walk: unit blockIdx.x + P (seq / H), part
  // seq % H.  Copies its rows of J, rx and s into ring slot `buf`.
  auto has = [&](int seq) { return blockIdx.x + P * (seq / H) < nunits; };
  auto row0 = [&](int seq) {
    return (long long)(blockIdx.x + P * (seq / H)) * kUnit + (seq % H) * RB;
  };
  auto copy_in = [&](int seq, int buf) {
    const long long r0 = row0(seq);
    T* tile = tiles + (size_t)buf * RB * np;
    if (vec) {
      for (int q = tid; q < RB * cpr; q += kThreads) {
        const int r = q / cpr, ch = q - r * cpr;
        const bool live = r0 + r < m;
        const T* src = live ? J + (size_t)(r0 + r) * n + ch * kChunk : J;
        cp_async16(tile + r * np + ch * kChunk, src, live ? 16 : 0);
      }
    } else {
      for (int q = tid; q < RB * n; q += kThreads) {
        const int r = q / n, c = q - r * n;
        const bool live = r0 + r < m;
        cp_async_elem(tile + r * np + c,
                      live ? J + (size_t)(r0 + r) * n + c : J, live);
      }
    }
    if ((GRAM || SCALE) && tid < RB) {
      const bool live = r0 + tid < m;
      if (GRAM) cp_async_elem(rxs + buf * RB + tid, live ? rx + r0 + tid : rx, live);
      if (SCALE) cp_async_elem(ss + buf * RB + tid, live ? s + r0 + tid : s, live);
    }
  };

  // The three stages of a tile, as the loop below schedules them.
  auto stage_x = [&](const T* tile) {
    // ---- X^T = (tile V)^T: rows 32 rt + lr + 4 a (a < 8), columns c0 .. + 3
    {
      const int nct = (kp / 4 + 7) / 8;
      for (int item = warp; item < nct * RT; item += kWarps) {
        const int ct = item / RT, rt = item - ct * RT;
        const int c0 = 4 * (8 * ct + lc);
        const int c0c = min(c0, kp - 4);
        const T* arow = tile + (32 * rt + lr) * np;
        T x[8][4];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) x[a][b] = T(0);
#pragma unroll 2
        for (int i = 0; i < n; ++i) {
          T av[8], bv[4];
          load4(Vs + i * kp + c0c, bv);
#pragma unroll
          for (int a = 0; a < 8; ++a) av[a] = arow[4 * a * np + i];
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) x[a][b] += av[a] * bv[b];
        }
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (c0 + b < k) {
#pragma unroll
            for (int a = 0; a < 8; ++a)
              Xt[(c0 + b) * RB + 32 * rt + lr + 4 * a] = x[a][b];
          }
      }
    }
  };
  auto stage_apply = [&](T* tile, int buf) {
    // ---- JQ1 tile = (tile - X W) * s, in place: rows 16 ru + 4 lr + a
    // (a < 4), columns c0 .. + 3 and c0 + 32 .. + 35 (a warp's reads of W
    // are two runs of 128 contiguous bytes)
    {
      const int nct = (np + 63) / 64;
      for (int item = warp; item < nct * RU; item += kWarps) {
        const int ct = item / RU, ru = item - ct * RU;
        const int c0 = 64 * ct + 4 * lc;
        const int c0c = min(c0, np - 4), c1c = min(c0 + 32, np - 4);
        const int rbase = 16 * ru + 4 * lr;
        T y[4][8];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) y[a][b] = T(0);
#pragma unroll 2
        for (int q = 0; q < k; ++q) {
          T av[4], bv[8];
          load4(Xt + q * RB + rbase, av);
          load4(Ws + q * np + c0c, *reinterpret_cast<T(*)[4]>(bv));
          load4(Ws + q * np + c1c, *reinterpret_cast<T(*)[4]>(bv + 4));
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) y[a][b] += av[a] * bv[b];
        }
        // (columns n .. np - 1 of the tile are padding: whatever lands
        // there is never read as a result)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (c0 + 32 * h < np) {
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              T* trow = tile + (rbase + a) * np + c0 + 32 * h;
              const T sc = SCALE ? ss[buf * RB + rbase + a] : T(1);
              T v[4];
              load4(trow, v);
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                v[b] -= y[a][4 * h + b];
                if (SCALE) v[b] *= sc;
              }
              store4(trow, v);
            }
          }
      }
    }
  };
  auto stage_out_gram = [&](const T* tile, int buf, long long r0) {
    // ---- JQ1 out to device memory from the finished tile ------------------
    if (OUT) {
      if (vec) {
        for (int q = tid; q < RB * cpr; q += kThreads) {
          const int r = q / cpr, ch = q - r * cpr;
          if (r0 + r < m)
            *reinterpret_cast<int4*>(out + (size_t)(r0 + r) * n + ch * kChunk) =
                *reinterpret_cast<const int4*>(tile + r * np + ch * kChunk);
        }
      } else {
        for (int q = tid; q < RB * n; q += kThreads) {
          const int r = q / n, c = q - r * n;
          if (r0 + r < m) out[(size_t)(r0 + r) * n + c] = tile[r * np + c];
        }
      }
    }

    // ---- G += JQ1t^T JQ1t (upper patches), p += JQ1t^T rx, in registers ---
    if (GRAM) {
      if (gi >= 0) {
        // (offsets past the padded row are pulled back: those entries are
        // summed on valid columns and never stored)
        const int a0 = min(gi, np - 4), a1 = min(gi + 4, np - 4);
        const int b0 = min(gj, np - 4), b1 = min(gj + 4, np - 4);
#pragma unroll 2
        for (int r = 0; r < RB; ++r) {
          const T* row = tile + r * np;
          T av[8], bv[8];
          load4(row + a0, *reinterpret_cast<T(*)[4]>(av));
          load4(row + a1, *reinterpret_cast<T(*)[4]>(av + 4));
          load4(row + b0, *reinterpret_cast<T(*)[4]>(bv));
          load4(row + b1, *reinterpret_cast<T(*)[4]>(bv + 4));
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[a][b] += av[a] * bv[b];
        }
      }
      // p: column tid % 128, rows of part tid / 128 of the tile
      if ((tid & 127) < n) {
        constexpr int kPartRows = RB / (kThreads / 128);
        const int rlo = (tid >> 7) * kPartRows;
        const T* rxt = rxs + buf * RB + rlo;
        const T* col = tile + rlo * np + (tid & 127);
#pragma unroll 4
        for (int r = 0; r < kPartRows; ++r) pacc += rxt[r] * col[r * np];
      }
    }
  };

  // Schedule.  With a ring of two, X of tile t + 1 (the low warps) runs in
  // the same phase as the Gram of tile t (the high warps), and the copy of
  // tile t + 2 flies during the apply of tile t + 1:
  //   apply(t) | X(t + 1), out + Gram + p (t) | copy t + 2 -> slot of t.
  // With one slot the stages run in turn.
  if (has(0)) copy_in(0, 0);
  cp_async_commit();
  if (NS == 2) {
    if (has(1)) copy_in(1, 1);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  stage_x(tiles);
  __syncthreads();

  for (int seq = 0; has(seq); ++seq) {
    const int buf = NS == 2 ? (seq & 1) : 0;
    T* tile = tiles + (size_t)buf * RB * np;
    stage_apply(tile, buf);
    if (NS == 2) cp_async_wait<0>();        // tile seq + 1 has landed
    __syncthreads();
    if (NS == 2 && has(seq + 1)) stage_x(tiles + (size_t)(buf ^ 1) * RB * np);
    stage_out_gram(tile, buf, row0(seq));
    __syncthreads();                        // slot `buf` and X^T are free
    if (NS == 2) {
      if (has(seq + 2)) copy_in(seq + 2, buf);
      cp_async_commit();
    } else if (has(seq + 1)) {
      copy_in(seq + 1, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      stage_x(tiles);
      __syncthreads();
    }
  }
  cp_async_wait<0>();

  if (GRAM) {
    T* slot = ws + (size_t)blockIdx.x * ((size_t)n * n + n);
    if (gi >= 0) {
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int i = gi + a, j = gj + b;
          if (i <= j && j < n) slot[(size_t)i * n + j] = acc[a][b];
        }
    }
    // the parts of p, added in index order (the ring is idle by now)
    T* parts = tiles;
    if ((tid & 127) < n) parts[(tid >> 7) * n + (tid & 127)] = pacc;
    __syncthreads();
    if (tid < n) {
      T sum = T(0);
      for (int h = 0; h < kThreads / 128; ++h) sum += parts[h * n + tid];
      slot[(size_t)n * n + tid] = sum;
    }
  }
}

// gp[e] = sum over slots c = 0 .. nparts-1, in that order, of ws[c][e'],
// where e' is e for the upper triangle of G and for p, and the mirrored
// entry for the lower triangle (the blocks sum one triangle only).
template <typename T>
__global__ void wy_reduce_kernel(const T* __restrict__ ws, T* __restrict__ gp,
                                 int nparts, int n) {
  const int elems = n * n + n;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  int src = e;
  if (e < n * n) {
    const int i = e / n, j = e - i * n;
    if (i > j) src = j * n + i;
  }
  T sum = T(0);
  for (int c = 0; c < nparts; ++c) sum += ws[(size_t)c * elems + src];
  gp[e] = sum;
}

template <typename T, bool GRAM, bool SCALE, bool OUT, int RB, int NS>
int launch_tiled(const T* J, const T* V, const T* W, const T* rx, const T* s,
                 T* out, T* ws, T* gp, int m, int n, int k, int nparts,
                 cudaStream_t stream) {
  const size_t smem = shared_elems(n, k, (int)sizeof(T), RB, NS) * sizeof(T);
  auto kernel = wy_gram_kernel<T, GRAM, SCALE, OUT, RB, NS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nparts, kThreads, smem, stream>>>(J, V, W, rx, s, out, ws, m, n, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (GRAM) {
    const int elems = n * n + n;
    wy_reduce_kernel<T><<<(elems + 255) / 256, 256, 0, stream>>>(ws, gp, nparts,
                                                               n);
    err = cudaGetLastError();
  }
  return (int)err;
}

// Two 64-row tiles where the panel leaves room for them, one 32-row tile
// otherwise: a function of (n, k, type) and the card's limit only.
template <typename T, bool GRAM, bool SCALE, bool OUT>
int launch(const T* J, const T* V, const T* W, const T* rx, const T* s, T* out,
           T* ws, T* gp, int m, int n, int k, int nparts, size_t limit,
           cudaStream_t stream) {
  if (shared_elems(n, k, (int)sizeof(T), 64, 2) * sizeof(T) <= limit)
    return launch_tiled<T, GRAM, SCALE, OUT, 64, 2>(J, V, W, rx, s, out, ws, gp,
                                                    m, n, k, nparts, stream);
  if (shared_elems(n, k, (int)sizeof(T), 32, 1) * sizeof(T) <= limit)
    return launch_tiled<T, GRAM, SCALE, OUT, 32, 1>(J, V, W, rx, s, out, ws, gp,
                                                    m, n, k, nparts, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const void* J, const void* V, const void* W, const void* rx,
        const void* s, void* out, void* ws, void* gp, int m, int n, int k,
        int variant, int nparts, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n > kMaxN || nparts <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)limit;
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
// (m, n) (unused by variant 3); J and out 16-byte aligned where a row of J
// is a multiple of 16 bytes; ws (nparts, n n + n) scratch and gp
// (n n + n,) = [G row-major, p] (both unused by variant 0).  variant:
// 0 apply, 1 apply + Gram, 2 row-scaled apply + Gram, 3 row-scaled Gram
// without the JQ1 output.  nparts: blocks launched = partial sums kept.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns the first CUDA error (0 = success).
//
// The float64 entry point is csrc/wy_gram_f64.cu's: it includes this file
// with WY_GRAM_F64 defined, so the two halves compile side by side and load
// as two libraries, each with its own wy_gram_shared_bytes.
#ifndef WY_GRAM_F64
extern "C" int wy_gram_f32(const void* J, const void* V, const void* W,
                           const void* rx, const void* s, void* out, void* ws,
                           void* gp, int m, int n, int k, int variant,
                           int nparts, void* stream) {
  return run<float>(J, V, W, rx, s, out, ws, gp, m, n, k, variant, nparts,
                    stream);
}

// Shared memory (bytes) of the tiling with `rb`-row tiles in a ring of
// `stages`, as the kernel lays it out.
extern "C" long long wy_gram_shared_bytes(int n, int k, int itemsize, int rb,
                                          int stages) {
  return (long long)(shared_elems(n, k, itemsize, rb, stages) * itemsize);
}
#endif

extern "C" const char* wy_gram_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
