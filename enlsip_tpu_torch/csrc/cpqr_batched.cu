// Column-pivoted Householder QR of a BATCH of tiny matrices, for NVIDIA
// Hopper.
//
// Replaces the Pallas kernel enlsip_tpu/ops/pallas_batched_qr.py::_kernel
// and computes the same function per lane: for k = 0 .. kmax-1 the exact
// squared norms of rows >= k of columns >= k, the first maximum as pivot
// (a NaN norm never wins), the column (and perm) swap, one Householder
// reflector with beta = (alpha >= 0 ? -norm : norm), tau = 0 and v_k = 0
// where alpha - beta = 0, tau = 0 where beta = 0, its application to the
// columns > k only, and column k packed (R above the diagonal, beta on it
// -- alpha where the reflector is unsafe -- the reflector tail below).
// All kmax steps run: a step on a zero column gives tau = 0 and changes
// nothing, so masked buffers need no step count.
//
// Bound.  At the batched solver's largest shape, 10,000 lanes of 40 x 10
// float32, the function reads 16 MB and writes 16 MB (plus tau and perm):
// 9.8 us at 3.35 TB/s.  Its ~6 flops an element a step are far below the
// arithmetic peak.  What a lane waits for is its sequential chain, ten
// steps of pivot -> reflector -> dots -> update; what the card waits for,
// measured at that shape (chip_b2_variants.py, PERF.md), is the
// instruction throughput of the factorizations running side by side:
// leaving the global loads out saves little, leaving the factorization
// out most.
//
// Design.  A group of G threads factors one lane (G a power of two from 1
// to 32, so a warp holds 32 / G lanes and no group straddles two warps).
// Each warp copies its lanes once into shared memory, row-major per lane
// (row stride ld = cols made odd; lanes S elements apart with S = G * ld
// mod 32), factors them, and writes them out: no barrier wider than a
// warp, so the warps of a block and of an SM load, factor and store out of
// step with one another.  Thread t of a group owns rows t, t + G, t + 2G,
// ... < rows: the 32 threads of a warp read 32 rows (g * G + t) * ld apart,
// all on distinct banks, and a chunk's columns sit at immediate offsets
// from one row pointer.  A block holds L lanes in L * G threads rounded up
// to whole warps; where a lane's matrix is so large that fewer lanes fit
// shared memory than a warp has groups (and at the batch's end), the
// groups past the last lane idle, and the shuffles and warp barriers name
// only the working threads.
//
//   * Symmetric reductions.  Every sum over rows is a per-thread partial
//     in row order, then a butterfly v += shfl_xor(v, m) for m = 1, 2, ..
//     G/2.  Each level adds the same two values in every thread of the
//     group (a + b = b + a), so all G threads hold bit-identical norms and
//     dots and choose the same pivot with no barrier beyond the warp's.
//   * Fused passes.  The update of step k writes rows >= k of the columns
//     > k; the same pass sums the squares of the new values of rows >= k+1,
//     which are step k+1's norms: exact norms, not downdated ones.  The
//     squared norm of the pivot column is the reflector's norm.  Columns go
//     through in chunks of 8, then one of 4, 2 and 1 (no chunk is part
//     empty): a chunk's dots share one butterfly, then its next norms
//     another, so the shuffles of a chunk overlap.
//   * Shuffle arithmetic, which sizes G.  Two butterflies of depth log2 G
//     for each of ~cols columns a step: at (10,000, 40, 10) that is about
//     2 * 10 * 10 * log2 G warp-shuffles a lane.  At roughly one warp-
//     shuffle a clock an SM, G = 32 costs ~10^7 shuffles / 132 SMs ~ 40 us
//     and G = 4 ~ 17 us, the FMAs negligible beside them; fewer threads a
//     lane trade shuffle throughput for latency and occupancy, and more
//     repeat the work every thread of a group does once a step.  The
//     wrapper's rule group_size() is read off a sweep on the card.  The
//     row loops are not unrolled: unrolled, they run more instructions
//     and hold more registers, and the card measured them slower
//     (chip_b2_variants.py).
//   * No layout copies.  The input is read through its three strides (a
//     transposed view in place, walking the smaller stride fastest) and
//     never written; packed (B, rows, cols) row-major, tau (B, kmax) and
//     perm (B, cols) int64 are written fresh, warp by warp, coalesced.
//   * The tail of a reflector is divided by alpha - beta, as the TPU kernel
//     and the plain version do.  Multiplying by its reciprocal (LAPACK's
//     dlarfg) is a little faster, but a float32 batch solve follows its
//     lanes' rounding, and the ODE fit's trip count, set by one or two
//     lanes, moves with it (chip_b2_variants.py).
//   * Determinism.  No atomics; every sum has one order.  Two launches
//     give equal bits.

#include <cuda_runtime.h>

namespace {

constexpr int kSharedLimit = 232448;   // 227 KB of dynamic shared memory a block

__host__ __device__ inline int lane_ld(int cols) { return cols | 1; }

// Elements between two lanes' matrices: at least rows * ld, and = G * ld
// mod 32, so that row t of group g sits (g * G + t) * ld mod 32 banks on.
__host__ __device__ inline int lane_stride(int rows, int cols, int G) {
  const int ld = lane_ld(cols);
  const int s = rows * ld;
  return s + (((G * ld - s) % 32) + 32) % 32;
}

long long shared_bytes(int rows, int cols, int itemsize, int G, int L) {
  const int kmax = rows < cols ? rows : cols;
  return (long long)L * ((long long)(lane_stride(rows, cols, G) + kmax) * itemsize +
                         4LL * cols);
}

// Walks the positions (l, a, b), b fastest, of na * nb elements a lane,
// `step` at a time from `start`, and keeps the matching offsets in global
// memory (strides gl, ga, gb) and in shared memory (sl, sa, sb) by adds.
struct Walk {
  int l, a, b, na, nb, dl, da, db;
  long long g, g_step, g_carry_b, g_carry_a;
  int s, s_step, s_carry_b, s_carry_a;
  __device__ Walk(int start, int step, int na_, int nb_, long long gl,
                  long long ga, long long gb, int sl, int sa, int sb)
      : na(na_), nb(nb_) {
    b = start % nb;
    a = (start / nb) % na;
    l = start / nb / na;
    db = step % nb;
    da = (step / nb) % na;
    dl = step / nb / na;
    g = l * gl + a * ga + b * gb;
    g_step = dl * gl + da * ga + db * gb;
    g_carry_b = ga - nb * gb;
    g_carry_a = gl - na * ga;
    s = l * sl + a * sa + b * sb;
    s_step = dl * sl + da * sa + db * sb;
    s_carry_b = sa - nb * sb;
    s_carry_a = sl - na * sa;
  }
  __device__ void next() {
    b += db;
    a += da;
    l += dl;
    g += g_step;
    s += s_step;
    if (b >= nb) { b -= nb; ++a; g += g_carry_b; s += s_carry_b; }
    if (a >= na) { a -= na; ++l; g += g_carry_a; s += s_carry_a; }
  }
};

template <int W> struct Width { static constexpr int value = W; };

// Columns j .. cols-1 in chunks of 8, then one of 4, 2 and 1 as needed:
// every chunk is full, and the chunks go in increasing column order.
template <typename F>
__device__ __forceinline__ void in_chunks(int j, int cols, F&& f) {
  for (; j + 8 <= cols; j += 8) f(Width<8>(), j);
  if (j + 4 <= cols) { f(Width<4>(), j); j += 4; }
  if (j + 2 <= cols) { f(Width<2>(), j); j += 2; }
  if (j < cols) f(Width<1>(), j);
}

// One lane's factorization by the G threads of its group.  A is the lane's
// row-major matrix (row stride ld), t the thread's place in the group, R
// the number of rows it owns (t, t + G, ...), mask the warp's working
// threads.  Each thread reads and writes only its own rows, except alpha,
// which every thread reads after the warp barrier that follows the swap.
// best / piv: the next step's pivot and its squared norm, the same in
// every thread of the group.
template <typename T, int G>
struct LaneQR {
  T* A;
  int ld, t, R;
  unsigned mask;
  T best;
  int piv;

  __device__ T* row(int r) const { return A + (t + G * r) * ld; }

  template <int W>
  __device__ void butterfly(T (&v)[W]) const {
#pragma unroll
    for (int m = 1; m < G; m <<= 1) {
#pragma unroll
      for (int c = 0; c < W; ++c) v[c] += __shfl_xor_sync(mask, v[c], m);
    }
  }

  template <int W>
  __device__ void scan(const T (&s)[W], int j0) {
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (s[c] > best) {          // strict: ties keep the lowest; NaN never wins
        best = s[c];
        piv = j0 + c;
      }
  }

  // step 0's squared norms of columns j0 .. j0+W-1 (all rows), and the scan
  template <int W>
  __device__ void norms(int j0) {
    T s[W];
#pragma unroll
    for (int c = 0; c < W; ++c) s[c] = T(0);
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      const T* x = row(r) + j0;
#pragma unroll
      for (int c = 0; c < W; ++c) s[c] += x[c] * x[c];
    }
    butterfly(s);
    scan(s, j0);
  }

  // H = I - tau v v^T on columns j0 .. j0+W-1 (rows >= k; v_k = vk, the
  // tail in column k), then, if `next`, step k+1's squared norms of the
  // new rows >= k+1 and the scan
  template <int W>
  __device__ void reflect(int j0, int k, int r0, T vk, T tau, bool next) {
    T d[W];
#pragma unroll
    for (int c = 0; c < W; ++c) d[c] = T(0);
#pragma unroll 1
    for (int r = r0; r < R; ++r) {
      const T* x = row(r);
      const T v = (t + G * r == k) ? vk : x[k];
#pragma unroll
      for (int c = 0; c < W; ++c) d[c] += v * x[j0 + c];
    }
    butterfly(d);
    T s[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      d[c] *= tau;                                // w = tau * (v^T x)
      s[c] = T(0);
    }
    const bool apply = tau != T(0);
#pragma unroll 1
    for (int r = r0; r < R; ++r) {
      T* x = row(r);
      const bool below = t + G * r > k;
      const T v = below ? x[k] : vk;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        T y = x[j0 + c];
        if (apply) {
          y -= d[c] * v;
          x[j0 + c] = y;
        }
        if (below) s[c] += y * y;
      }
    }
    if (next) {
      butterfly(s);
      scan(s, j0);
    }
  }
};

// One lane's factorization: A its matrix, P its perm, taus its tau.
template <typename T, int G>
__device__ void factor_lane(T* A, int* P, T* taus, int rows, int cols, int t,
                            unsigned mask) {
  LaneQR<T, G> q{A, lane_ld(cols), t, t < rows ? (rows - 1 - t) / G + 1 : 0,
                 mask, T(-1), 0};
  in_chunks(0, cols, [&](auto w, int j0) {
    q.template norms<decltype(w)::value>(j0);
  });
  const int kmax = rows < cols ? rows : cols;
  for (int k = 0; k < kmax; ++k) {
    // ---- swap columns k <-> piv (each thread its rows) and perm ----------
    const int piv = q.piv;
    if (piv != k) {
      for (int r = 0; r < q.R; ++r) {
        T* x = q.row(r);
        const T y = x[k];
        x[k] = x[piv];
        x[piv] = y;
      }
      if (t == 0) {
        const int p = P[k];
        P[k] = P[piv];
        P[piv] = p;
      }
    }
    __syncwarp(mask);
    // ---- Householder reflector: the pivot's squared norm is its norm -----
    const T alpha = A[k * q.ld + k];
    const T signorm = sqrt(q.best);
    const T beta = (alpha >= T(0)) ? -signorm : signorm;
    T denom = alpha - beta;
    const bool safe = fabs(denom) > T(0);
    if (!safe) denom = T(1);
    const T tau = (safe && beta != T(0)) ? (beta - alpha) / beta : T(0);
    const T vk = safe ? T(1) : T(0);
    const int r0 = k > t ? (k - t + G - 1) / G : 0;   // first owned row >= k
    for (int r = r0; r < q.R; ++r)
      if (t + G * r > k) q.row(r)[k] = q.row(r)[k] / denom;
    // ---- the columns > k, and step k+1's pivot -----------------------------
    const bool next = k + 1 < kmax;
    q.best = T(-1);
    q.piv = k + 1;
    in_chunks(k + 1, cols, [&](auto w, int j0) {
      q.template reflect<decltype(w)::value>(j0, k, r0, vk, tau, next);
    });
    __syncwarp(mask);                         // every thread has read alpha
    if (t == k % G) A[k * q.ld + k] = safe ? beta : alpha;
    if (t == 0) taus[k] = tau;
  }
}

template <typename T, int G>
__global__ void cpqr_batched_kernel(const T* __restrict__ M, long long sB,
                                    long long sR, long long sC,
                                    T* __restrict__ packed, T* __restrict__ tau_out,
                                    long long* __restrict__ perm_out, int rows,
                                    int cols, int nbatch, int L) {
  constexpr int kWarpLanes = 32 / G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kmax = rows < cols ? rows : cols;
  const int ld = lane_ld(cols);
  const int S = lane_stride(rows, cols, G);
  // This warp's lanes: `nl` slots of the block from `w0`, of which the
  // first `live` hold lanes of the batch, from lane `first`.
  const int lid = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * kWarpLanes;
  const int nl = L - w0 < kWarpLanes ? L - w0 : kWarpLanes;
  const long long first = (long long)blockIdx.x * L + w0;
  const int live = nbatch - first < nl ? (int)(nbatch - first) : nl;
  if (live <= 0) return;
  T* mats = reinterpret_cast<T*>(smem_raw) + (size_t)w0 * S;
  T* taus = reinterpret_cast<T*>(smem_raw) + (size_t)L * S + (size_t)w0 * kmax;
  int* perms = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw) +
                                      (size_t)L * (S + kmax)) + w0 * cols;
  const int nelem = live * rows * cols;

  // ---- the warp's lanes into shared memory, through the caller's strides,
  // walking the smaller of the row and column strides fastest
  {
    const bool rows_fast = sR <= sC;
    Walk w(lid, 32, rows_fast ? cols : rows, rows_fast ? rows : cols, sB,
           rows_fast ? sC : sR, rows_fast ? sR : sC, S, rows_fast ? 1 : ld,
           rows_fast ? ld : 1);
    const T* base = M + first * sB;
#pragma unroll 8
    for (int e = lid; e < nelem; e += 32, w.next()) mats[w.s] = base[w.g];
    for (int e = lid; e < live * cols; e += 32) perms[e] = e % cols;
  }
  __syncwarp();

  const int g = lid / G;                            // lane within the warp
  if (g < live) {
    const int busy = live * G;                      // a prefix of whole groups
    factor_lane<T, G>(mats + g * S, perms + g * cols, taus + g * kmax, rows,
                      cols, lid % G,
                      busy >= 32 ? 0xffffffffu : (1u << busy) - 1u);
  }
  __syncwarp();

  // ---- packed (row-major), tau and perm out, coalesced ---------------------
  {
    Walk w(lid, 32, rows, cols, (long long)rows * cols, cols, 1, S, ld, 1);
    T* base = packed + first * rows * cols;
#pragma unroll 8
    for (int e = lid; e < nelem; e += 32, w.next()) base[w.g] = mats[w.s];
    for (int e = lid; e < live * kmax; e += 32)
      tau_out[first * kmax + e] = taus[e];
    for (int e = lid; e < live * cols; e += 32)
      perm_out[first * cols + e] = perms[e];
  }
}

template <typename T, int G>
int launch_group(const T* M, long long sB, long long sR, long long sC,
                 T* packed, T* tau, long long* perm, int rows, int cols,
                 int nbatch, int L, cudaStream_t stream) {
  static bool raised = false;       // the 48 KB default, lifted once
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        cpqr_batched_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedLimit);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const int threads = (L * G + 31) / 32 * 32;
  const int nblk = (nbatch + L - 1) / L;
  cpqr_batched_kernel<T, G>
      <<<nblk, threads, (size_t)shared_bytes(rows, cols, (int)sizeof(T), G, L),
         stream>>>(M, sB, sR, sC, packed, tau, perm, rows, cols, nbatch, L);
  return (int)cudaGetLastError();
}

template <typename T>
int cpqr_batched_run(const T* M, long long sB, long long sR, long long sC,
                     T* packed, T* tau, long long* perm, int rows, int cols,
                     int nbatch, int G, int L, cudaStream_t stream) {
  if (nbatch <= 0 || rows <= 0 || cols <= 0) return 0;
  if (L < 1 || shared_bytes(rows, cols, (int)sizeof(T), G, L) > kSharedLimit ||
      (L * G + 31) / 32 * 32 > 1024)
    return (int)cudaErrorInvalidValue;
  switch (G) {
    case 1: return launch_group<T, 1>(M, sB, sR, sC, packed, tau, perm, rows, cols, nbatch, L, stream);
    case 2: return launch_group<T, 2>(M, sB, sR, sC, packed, tau, perm, rows, cols, nbatch, L, stream);
    case 4: return launch_group<T, 4>(M, sB, sR, sC, packed, tau, perm, rows, cols, nbatch, L, stream);
    case 8: return launch_group<T, 8>(M, sB, sR, sC, packed, tau, perm, rows, cols, nbatch, L, stream);
    case 16: return launch_group<T, 16>(M, sB, sR, sC, packed, tau, perm, rows, cols, nbatch, L, stream);
    case 32: return launch_group<T, 32>(M, sB, sR, sC, packed, tau, perm, rows, cols, nbatch, L, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface.  M: (B, rows, cols) read through its strides (in elements),
// never written; packed: (B, rows, cols) row-major; tau: (B, kmax); perm:
// (B, cols) int64, all written in full.  G threads a lane, L lanes a block
// (L * G threads rounded up to whole warps, at most 1024).  Launches one kernel on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a G or L the kernel does not take).
extern "C" int cpqr_batched_f32(const void* M, long long sB, long long sR,
                                long long sC, void* packed, void* tau,
                                void* perm, int rows, int cols, int nbatch,
                                int G, int L, void* stream) {
  return cpqr_batched_run<float>((const float*)M, sB, sR, sC, (float*)packed,
                                 (float*)tau, (long long*)perm, rows, cols,
                                 nbatch, G, L, (cudaStream_t)stream);
}

extern "C" int cpqr_batched_f64(const void* M, long long sB, long long sR,
                                long long sC, void* packed, void* tau,
                                void* perm, int rows, int cols, int nbatch,
                                int G, int L, void* stream) {
  return cpqr_batched_run<double>((const double*)M, sB, sR, sC,
                                  (double*)packed, (double*)tau,
                                  (long long*)perm, rows, cols, nbatch, G, L,
                                  (cudaStream_t)stream);
}

// Dynamic shared memory of one block, as the launch requests it; the
// wrapper's _shared_bytes says the same.
extern "C" long long cpqr_batched_shared_bytes(int rows, int cols, int itemsize,
                                               int G, int L) {
  return shared_bytes(rows, cols, itemsize, G, L);
}

extern "C" const char* cpqr_batched_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
