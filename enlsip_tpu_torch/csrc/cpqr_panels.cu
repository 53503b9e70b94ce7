// Column-pivoted Householder QR of one dense matrix too large for the
// card's shared memory, for NVIDIA Hopper: B1's panel route.
//
// Replaces, for the shapes whose matrix the resident route
// (csrc/cpqr.cu) cannot hold, what the JAX package computes there:
// enlsip_tpu/ops/blocked_qr.py::_cpqr_xla_panels, the LAPACK geqp3 /
// xLAQPS structure, which the TPU runs above its 12 MB VMEM gate
// (pallas_qr2.py::fits_vmem) in place of its Pallas kernel
// (pallas_qr2.py::_kernel).  Within a panel of NB = 128 steps the matrix
// stays stale; each reflector's effect is carried by an accumulator F
// (cols, NB); pivots are chosen on DOWNDATED norms (nrm2 -= rowk^2),
// computed exactly again at every panel start; one update B -= Vp F^T
// ends the panel.  A step count is read from device memory and clamped,
// as in the resident route, and panels past it are skipped whole (in the
// reference they are exact no-ops).  The result is packed as the
// resident route packs it: (cols, rows) with R above the diagonal, the
// Householder beta on it and the reflector tails below, tau and the
// pivot permutation (int64) beside it.
//
// Bound.  A step reads the stale trailing block once (B^T v), a few
// vectors and the panel's reflectors (from L2); the panel's update does
// 2 NB flops an element of the trailing block.  At cr5000's A_act^T
// (5000 x 4998) the reads come to about 3.3e11 bytes at float64 (1.7e11
// at float32); 2.9e11 of them fall in the steps whose trailing block
// exceeds the 50 MB L2, ~87 ms at the HBM rate, fewer where a step reads
// first what the step before read last; and every step is a chain of
// card-wide dependencies (pivot -> reflector -> F column -> downdated
// norms), so the latency of a step adds to that.
//
// Design: one persistent cooperative launch of at most one block an SM.
//   * Ownership.  Block b owns columns b, b + G, b + 2G, ... for the
//     whole run, keeps their rows of F and their norms in shared memory,
//     and keeps their current positions; a pivot exchange edits positions
//     only (the column at position k and the winner swap), so F rows and
//     norms never move.  The working matrix is a transposed copy W (cols,
//     rows padded to 4, so that 16-byte loads reach every column) in
//     global memory, made by the launch itself; the reflector of
//     position k is written, as it is formed, as the tail of packed column
//     k, which is where the later steps read it from.
//   * Three grid-wide barriers a step (the resident route's arrive / wait
//     pair on a counter in L2):
//       B1  every block has published its best live column by (downdated
//           norm, position) and that column's F row;
//       B2  bcol = W[:, c] - Vp F[c, :j] has been formed in 32-row slices,
//           a block a slice and its 16 warps splitting the reflectors,
//           with each slice's sum of squares;
//       B3  every block has summed the slices into the reflector (the same
//           arithmetic in every block, so the same bits), written the
//           tails, staged v in shared memory (the whole of v up to 48 KB,
//           else by chunks), formed Vp^T v in 512-row partials over the
//           grid's warps, and its share of W^T v: one stream of tasks
//           (live column, segment of 8 16-byte loads a lane) dealt round
//           robin to all the grid's warps, whichever block owns the
//           column, so that every SM streams the same bytes however the
//           pivots took the columns.  Every block keeps the chosen
//           columns as a bitmap (it knows each step's pivot) and, at each
//           panel's start, the list of live columns, so every block deals
//           the same tasks.  A warp loads its next task while it sums the
//           current one; the list is walked forward on even steps and
//           backward on odd ones, and all but the last 16 MB a step reads
//           are loaded with L2 priority evict_first, so that what a step
//           read last, the next reads first, from the L2; each partial
//           goes to its slot (column, segment) in global memory.
//     After B3 each block adds its own columns' partials in segment order,
//     forms F[:, j], row k of the updated matrix and the downdated norms
//     of its own columns; the next step's candidates follow without a
//     barrier.
//   * Panel end: every block applies Vp F^T to its live columns and to the
//     rows above the diagonal of the columns chosen in the panel, from
//     tiles of Vp staged in shared memory, and sums the next
//     panel's exact norms in the same sweep.  No barrier: the next step's
//     B1 orders it before any other block reads those columns.
//   * At the end every block writes its columns to their packed positions
//     (R and beta of the chosen ones; the whole updated column of the
//     others) and their entries of perm.
//
// Determinism.  No floating-point atomics, and every sum has a fixed
// order that does not depend on the block count: a sum over rows by one
// warp, lane i taking the rows (or 16-byte vectors) equal to i mod 32 in
// increasing order, then a butterfly; longer sums by fixed row slices,
// added in slice order (W^T v's segments from row k & ~127, whichever
// warp summed each); bcol's sums over reflectors by fixed residues
// mod 16, added in warp order.  Two launches give the same bits, and so
// do two block counts.
//
// Measured (chip_panels_phases.py and chip_smoke.py's b1_panels on an
// H100, PERF.md): at cr5000's A_act^T in float64 the W^T v sweep and its
// barrier take ~98 ms of a ~220 ms launch, 3.4 TB/s over its 3.4e11
// bytes (the L2 serving part of them); the rest of a step, about 25 us,
// is the latency of its barriers and dependent loads and the panel ends.
//
// Precision.  Full precision of the type, float32 or float64, as in the
// resident route: no TF32 and no bfloat16.  Options.matmul_precision does
// not reach this kernel.

#include <cuda_runtime.h>
#include <climits>
#include <cstdio>

#include "cpqr_common.cuh"

namespace {

using namespace cpqr_common;

constexpr int kPanThreads = 512;                 // threads of a block
constexpr int kPanWarps = kPanThreads / 32;
constexpr int kW2Chunk = 512;                    // rows of a Vp^T v partial
constexpr int kMaxNB = 128;                      // panel width at most
constexpr int kTile = 64;                        // transposition tile
constexpr int kStageBytes = 8 * kTile * (kTile + 1);   // the stage at least
constexpr int kVBytes = 48 * 1024;               // v staged at once, at most
constexpr int kMaxQ = 8;                         // own columns of a warp
constexpr int kSegVec = 8;                       // vectors a lane, W^T v task
constexpr int kSegBytes = kSegVec * 32 * 16;     // a W^T v task's bytes
// W^T v's tasks read last in a step (16 MB), which the L2 keeps for the
// next step to read first: the others are loaded with L2 priority
// evict_first (on an H100, 16-20 MB kept came out best; 4 and 40 worse)
constexpr int kKeepTasks = (16 << 20) / kSegBytes;
// values of type T the stage holds at least
template <typename T>
__host__ __device__ constexpr int stage_len() { return kStageBytes / sizeof(T); }
static_assert(32 * (kMaxNB + 1) <= stage_len<double>() &&
              kPanThreads <= stage_len<double>(), "stage too small");
static_assert(kVBytes % kSegBytes == 0, "v is staged by whole segments");

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// 16-byte vectors of the working matrix's columns (padded to a multiple of
// 4 rows, so every column starts 16-byte aligned): products summed in
// component order.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  // a 16-byte load past L1 with an L2 eviction policy
  static __device__ __forceinline__ float4 load(const float4* p,
                                                unsigned long long pol) {
    float4 r;
    asm volatile("ld.global.cg.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
                 : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
                 : "l"(p), "l"(pol));
    return r;
  }
  static __device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
    acc += a.x * b.x; acc += a.y * b.y; acc += a.z * b.z; acc += a.w * b.w;
    return acc;
  }
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ double2 load(const double2* p,
                                                 unsigned long long pol) {
    double2 r;
    asm volatile("ld.global.cg.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;"
                 : "=d"(r.x), "=d"(r.y)
                 : "l"(p), "l"(pol));
    return r;
  }
  static __device__ __forceinline__ double dot(double2 a, double2 b, double acc) {
    acc += a.x * b.x; acc += a.y * b.y;
    return acc;
  }
};

// Built with -DCPQR_PANELS_CLOCKS, block 0's first thread adds the time
// of each phase of the step loop (ns, from %globaltimer) and prints the
// sums at the end: where a factorization's time goes, for tuning.
#ifdef CPQR_PANELS_CLOCKS
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE(n)                                   \
  do {                                             \
    if (b == 0 && tid == 0) {                      \
      const long long t_now = global_ns();         \
      clk[n] += t_now - t_last;                    \
      t_last = t_now;                              \
    }                                              \
  } while (0)
#else
#define PHASE(n) \
  do {           \
  } while (0)
#endif

__host__ __device__ inline size_t align256(size_t x) {
  return (x + 255) & ~(size_t)255;
}

// Rows of a column of the working matrix W: rows rounded up to 4.
__host__ __device__ inline int padded_rows(int rows) { return (rows + 3) & ~3; }

// Rows of a W^T v task, a segment (512 at float64, 1,024 at float32), and
// segments of a column of W.
__host__ __device__ inline int seg_rows(size_t itemsize) {
  return kSegBytes / (int)itemsize;
}
__host__ __device__ inline int seg_count(int rows, size_t itemsize) {
  return (padded_rows(rows) + seg_rows(itemsize) - 1) / seg_rows(itemsize);
}

// Rows of v staged in shared memory at once: the whole of v where it takes
// at most kVBytes, else kVBytes' worth of whole segments.
__host__ __device__ inline int v_rows(int rows, size_t itemsize) {
  const int whole = seg_count(rows, itemsize) * seg_rows(itemsize);
  const int most = kVBytes / (int)itemsize;
  return whole < most ? whole : most;
}

// The stage: transposition tiles, bcol's partial sums, v, the panel end's
// tiles of Vp (16-byte multiple).
__host__ __device__ inline size_t stage_bytes(int rows, size_t itemsize) {
  const size_t v = (size_t)v_rows(rows, itemsize) * itemsize;
  return v > (size_t)kStageBytes ? v : (size_t)kStageBytes;
}

// Byte offsets of the scratch buffer's parts (one allocation the wrapper
// makes): the working matrix W (cols, padded rows), bcol (rows), the
// 32-row sums of squares, the Vp^T v partials (512-row slices x nb), the
// W^T v partials (cols x segments), and the blocks' pivot candidates
// (value, F row, position, column).
struct PanelLayout {
  size_t W, bcol, sumsq, w2part, w1part, cval, cF, cpos, ccol, total;
};

__host__ __device__ inline PanelLayout panel_layout(int rows, int cols,
                                                    int blocks, int nb,
                                                    size_t itemsize) {
  PanelLayout L;
  size_t o = 0;
  L.W = o;
  o = align256(o + (size_t)cols * padded_rows(rows) * itemsize);
  L.bcol = o;
  o = align256(o + (size_t)rows * itemsize);
  L.sumsq = o;
  o = align256(o + (size_t)((rows + 31) / 32) * itemsize);
  L.w2part = o;
  o = align256(o + (size_t)((rows + kW2Chunk - 1) / kW2Chunk) * nb * itemsize);
  L.w1part = o;
  o = align256(o + (size_t)cols * seg_count(rows, itemsize) * itemsize);
  L.cval = o;
  o = align256(o + (size_t)blocks * itemsize);
  L.cF = o;
  o = align256(o + (size_t)blocks * nb * itemsize);
  L.cpos = o;
  o = align256(o + (size_t)blocks * sizeof(int));
  L.ccol = o;
  o = align256(o + (size_t)blocks * sizeof(int));
  L.total = o;
  return L;
}

// Dynamic shared memory of a block: the stage, the F rows, norms, W^T v
// and row k of its columns, four panel-width vectors, its columns'
// positions, and, the same in every block, the chosen columns (one bit a
// column) and the panel's list of live columns (16-bit indices).
__host__ __device__ inline size_t panels_shared_bytes(int rows, int cols,
                                                      int blocks, int nb,
                                                      size_t itemsize) {
  const size_t nloc = (size_t)(cols + blocks - 1) / blocks;
  return stage_bytes(rows, itemsize) +
         (nloc * (nb + 3) + 4 * (size_t)nb) * itemsize + nloc * sizeof(int) +
         (size_t)((cols + 31) / 32) * sizeof(unsigned) +
         (size_t)cols * sizeof(unsigned short);
}

template <typename T>
__global__ void __launch_bounds__(kPanThreads, 1)
cpqr_panels(const T* __restrict__ M, T* out, T* tauv,
            long long* __restrict__ perm, unsigned char* scratch,
            int* counter, const int* nsteps_p, int rows, int cols, int kp,
            int nb) {
  using V = typename Vec16<T>::type;
  constexpr int VN = Vec16<T>::n;
  constexpr int kSeg = kSegVec * 32 * VN;        // rows of a W^T v task
  const int nsteps = step_count(nsteps_p, rows, cols);
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = G * kPanWarps;                  // warps of the grid
  const int nlocmax = (cols + G - 1) / G;
  const int nloc = (cols - b + G - 1) / G;       // columns b, b + G, ...
  const int ldw = padded_rows(rows);
  const int nchunk32 = (rows + 31) / 32;
  const int nchunkW = (rows + kW2Chunk - 1) / kW2Chunk;
  const int nwd = (cols + 31) / 32;              // words of the bitmap
  const int nsegw = seg_count(rows, sizeof(T));  // W^T v partials a column
  const int vrows = v_rows(rows, sizeof(T));     // rows of v staged at once

  const PanelLayout L = panel_layout(rows, cols, G, nb, sizeof(T));
  T* W = reinterpret_cast<T*>(scratch + L.W);
  T* bcol = reinterpret_cast<T*>(scratch + L.bcol);
  T* sumsq = reinterpret_cast<T*>(scratch + L.sumsq);
  T* w2part = reinterpret_cast<T*>(scratch + L.w2part);
  T* w1part = reinterpret_cast<T*>(scratch + L.w1part);
  T* cval = reinterpret_cast<T*>(scratch + L.cval);
  T* cF = reinterpret_cast<T*>(scratch + L.cF);
  int* cpos = reinterpret_cast<int*>(scratch + L.cpos);
  int* ccol = reinterpret_cast<int*>(scratch + L.ccol);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kStageT = stage_len<T>();       // the stage's least length
  T* stage = reinterpret_cast<T*>(smem_raw);     // 16-byte aligned
  T* F = reinterpret_cast<T*>(smem_raw + stage_bytes(rows, sizeof(T)));
                                                 // (nlocmax, nb)
  T* nrm = F + (size_t)nlocmax * nb;             // (nlocmax,)
  T* w1s = nrm + nlocmax;                        // (nlocmax,) W^T v
  T* wks = w1s + nlocmax;                        // (nlocmax,) row k of W
  T* Fc = wks + nlocmax;                         // (nb,) the winner's F row
  T* w2s = Fc + nb;                              // (nb,) Vp^T v
  T* vpk = w2s + nb;                             // (nb,) row k of Vp
  T* unitp = vpk + nb;                           // (nb,) Vp's unit diagonal
  int* lpos = reinterpret_cast<int*>(unitp + nb);  // (nlocmax,)
  unsigned* chosen = reinterpret_cast<unsigned*>(lpos + nlocmax);  // (nwd,)
  unsigned short* live = reinterpret_cast<unsigned short*>(chosen + nwd);
                                                 // (cols,) the panel's list
  __shared__ int s_nlive;
  __shared__ T s_tau, s_den, s_unit, s_diag;
  __shared__ int s_piv, s_col, s_blk;

  int round = 0;
  auto grid_sync = [&]() {
    __syncthreads();
    ++round;
    if (tid == 0) {
      grid_arrive(counter);
      grid_wait(counter, round * G);
    }
    __syncthreads();
  };
  auto colW = [&](int l) { return W + (size_t)(b + l * G) * ldw; };
#ifdef CPQR_PANELS_CLOCKS
  long long clk[12] = {0}, t_last = global_ns();
#endif

  // ---- W = M^T, in 64 x 64 tiles spread over the blocks; the padding
  // rows of W are zero ---------------------------------------------------
  {
    const int ntr = (ldw + kTile - 1) / kTile, ntc = (cols + kTile - 1) / kTile;
    const long long ntile = (long long)ntr * ntc;
    for (long long tile = b; tile < ntile; tile += G) {
      const int tr = (int)(tile / ntc), tc = (int)(tile % ntc);
#pragma unroll
      for (int m = 0; m < kTile / kPanWarps; ++m) {
        const int r = warp + m * kPanWarps, i = tr * kTile + r;
#pragma unroll
        for (int h = 0; h < kTile / 32; ++h) {
          const int c = tc * kTile + lane + 32 * h;
          if (i < rows && c < cols)
            stage[r * (kTile + 1) + lane + 32 * h] = M[(size_t)i * cols + c];
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kTile / kPanWarps; ++m) {
        const int r = warp + m * kPanWarps, c = tc * kTile + r;
#pragma unroll
        for (int h = 0; h < kTile / 32; ++h) {
          const int i = tr * kTile + lane + 32 * h;
          if (c < cols && i < ldw)
            W[(size_t)c * ldw + i] =
                i < rows ? stage[(lane + 32 * h) * (kTile + 1) + r] : T(0);
        }
      }
      __syncthreads();
    }
  }
  for (int l = tid; l < nloc; l += kPanThreads) lpos[l] = b + l * G;
  // the bits past the last column count as chosen
  for (int w = tid; w < nwd; w += kPanThreads)
    chosen[w] = (w == nwd - 1 && (cols & 31)) ? ~((1u << (cols & 31)) - 1u) : 0u;
  for (int e = tid; e < nlocmax * nb; e += kPanThreads) F[e] = T(0);
  grid_sync();
  // exact norms at the first panel's start, one warp a column
  for (int l = warp; l < nloc; l += kPanWarps) {
    const V* col = reinterpret_cast<const V*>(colW(l));
    T acc = T(0);
#pragma unroll 4
    for (int g = lane; g < ldw / VN; g += 32) {
      const V x = __ldcg(col + g);
      acc = Vec16<T>::dot(x, x, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) nrm[l] = acc;
  }
  __syncthreads();
  PHASE(11);

  for (int s = 0; s < nsteps; s += nb) {
    const int jn = min(nb, nsteps - s);
    // ---- the panel's list of live columns, in column order, from the
    // bitmap every block keeps alike: W^T v's tasks until the panel ends
    // (a column chosen inside the panel is skipped by its bit)
    {
      int* wbase = reinterpret_cast<int*>(stage);   // (nwd,) first entries
      if (warp == 0) {
        int n = 0;
        for (int w0 = 0; w0 < nwd; w0 += 32) {
          const int w = w0 + lane;
          const int cnt = w < nwd ? __popc(~chosen[w]) : 0;
          int inc = cnt;
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, inc, o);
            if (lane >= o) inc += y;
          }
          if (w < nwd) wbase[w] = n + inc - cnt;
          n += __shfl_sync(0xffffffffu, inc, 31);
        }
        if (lane == 0) s_nlive = n;
      }
      __syncthreads();
      for (int w = tid; w < nwd; w += kPanThreads) {
        unsigned bits = ~chosen[w];
        for (int e = wbase[w]; bits; bits &= bits - 1u, ++e)
          live[e] = (unsigned short)(w * 32 + __ffs(bits) - 1);
      }
      __syncthreads();
    }
    const int nlive = s_nlive;
    for (int j = 0; j < jn; ++j) {
      const int k = s + j;

      // ---- this block's candidate: best live column by (norm, position);
      // a block whose live columns all have NaN norms offers its lowest
      // position with value -1, so that position k always has an offer
      if (warp == 0) {
        T bv = T(-1);
        int bi = INT_MAX, bl = -1, fp = INT_MAX, fl = -1;
        for (int l = lane; l < nloc; l += 32) {
          const int p = lpos[l];
          if (p < k) continue;
          if (beats(nrm[l], p, bv, bi)) {
            bv = nrm[l];
            bi = p;
            bl = l;
          }
          if (p < fp) {
            fp = p;
            fl = l;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const T ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
          const int ofp = __shfl_xor_sync(0xffffffffu, fp, o);
          const int ofl = __shfl_xor_sync(0xffffffffu, fl, o);
          if (beats(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
            bl = ol;
          }
          if (ofp < fp) {
            fp = ofp;
            fl = ofl;
          }
        }
        if (bl < 0 && fl >= 0) {
          bi = fp;
          bl = fl;
        }
        if (lane == 0) {
          cval[b] = bv;
          cpos[b] = bi;
          ccol[b] = bl < 0 ? -1 : b + bl * G;
        }
        if (bl >= 0)
          for (int q = lane; q < j; q += 32)
            cF[(size_t)b * nb + q] = F[(size_t)bl * nb + q];
      }
      PHASE(0);
      grid_sync();                                                    // B1
      PHASE(1);

      // ---- the pivot: first maximum over the candidates, every block ----
      if (warp == 0) {
        T bv = T(-1);
        int bi = INT_MAX, bb = 0, bc = -1;
#pragma unroll 8
        for (int p = lane; p < G; p += 32) {
          const T cv = __ldcg(cval + p);
          const int ci = __ldcg(cpos + p);
          const int cc = __ldcg(ccol + p);
          if (beats(cv, ci, bv, bi)) {
            bv = cv;
            bi = ci;
            bb = p;
            bc = cc;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const T ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          const int ob = __shfl_xor_sync(0xffffffffu, bb, o);
          const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
          if (beats(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
            bb = ob;
            bc = oc;
          }
        }
        if (lane == 0) {
          s_piv = bi;
          s_blk = bb;
          s_col = bc;
        }
      }
      __syncthreads();
      const int piv = s_piv, c = s_col, wb = s_blk;
      // the exchange of positions k and piv, on this block's columns
      for (int l = tid; l < nloc; l += kPanThreads) {
        if (b + l * G == c)
          lpos[l] = k;
        else if (lpos[l] == k)
          lpos[l] = piv;
      }
      for (int q = tid; q < j; q += kPanThreads)
        Fc[q] = __ldcg(cF + (size_t)wb * nb + q);
      if (tid == 0) chosen[c >> 5] |= 1u << (c & 31);
      __syncthreads();
      PHASE(2);

      // ---- bcol = W[:, c] - Vp F[c, :j], rows >= k, in 32-row slices: a
      // block a slice, warp w summing the reflectors q = w mod 16, the
      // sixteen partial sums added in warp order ----------------------------
      const int t0 = k >> 5;
      const int ntk = nchunk32 - t0;
      const T* wc = W + (size_t)c * ldw;
      for (int t = b; t < ntk; t += G) {
        const int i = ((t0 + t) << 5) + lane;
        const bool row = i >= k && i < rows;
        const T wci = (warp == 0 && row) ? __ldcg(wc + i) : T(0);
        T part = T(0);
        if (row) {
#pragma unroll 8
          for (int q = warp; q < j; q += kPanWarps)
            part += __ldcg(out + (size_t)(s + q) * rows + i) * Fc[q];
        }
        stage[warp * 32 + lane] = part;
        __syncthreads();
        if (warp == 0) {
          T x = T(0);
          if (row) {
            T sum = stage[lane];
#pragma unroll
            for (int w = 1; w < kPanWarps; ++w) sum += stage[w * 32 + lane];
            x = wci - sum;
            bcol[i] = x;
          }
          const T sq = warp_sum(x * x);
          if (lane == 0) sumsq[t0 + t] = sq;
        }
        __syncthreads();
      }
      PHASE(3);
      grid_sync();                                                    // B2
      PHASE(4);

      // ---- the reflector, the same arithmetic in every block ------------
      if (warp == 0) {
        const T alpha = __ldcg(bcol + k);
        T ss = T(0);
#pragma unroll 4
        for (int t = t0 + lane; t < nchunk32; t += 32) ss += __ldcg(sumsq + t);
        ss = warp_sum(ss);
        if (lane == 0) {
          const T signorm = sqrt(ss);
          const T beta = (alpha >= T(0)) ? -signorm : signorm;
          const T den = alpha - beta;
          const bool safe = fabs(den) > T(0);
          // a zero tail gives tau = 0, v = 0 and keeps alpha on the diagonal
          s_tau = (safe && beta != T(0)) ? (beta - alpha) / beta : T(0);
          s_den = safe ? den : T(1);
          s_unit = safe ? T(1) : T(0);
          s_diag = safe ? beta : alpha;
        }
      }
      __syncthreads();
      const T tau = s_tau, denom = s_den, unit = s_unit;
      PHASE(5);
      if (b == wb && tid == 0) {
        W[(size_t)c * ldw + k] = s_diag;
        tauv[k] = tau;
      }
      // the tail of v, as the tail of packed column k (bcol's slices)
      for (int t = b; t < ntk; t += G) {
        const int i = ((t0 + t) << 5) + lane;
        if (warp == 0 && i > k && i < rows)
          out[(size_t)k * rows + i] = __ldcg(bcol + i) / denom;
      }
      // v staged in shared memory, rows [vr0, vr1) first (the whole of v
      // where it takes at most kVBytes)
      const int vr0 = k & ~127;
      const int nsg = (ldw - vr0 + kSeg - 1) / kSeg;   // W^T v's segments
      auto stage_v = [&](int r0, int r1) {
        __syncthreads();
        for (int i = r0 + tid; i < r1; i += kPanThreads)
          stage[i - r0] = (i < k || i >= rows)
                              ? T(0)
                              : (i == k ? unit : __ldcg(bcol + i) / denom);
        __syncthreads();
      };
      const int vr1 = min(ldw, vr0 + vrows);
      stage_v(vr0, vr1);
      // Vp^T v in 512-row partials, one warp a (slice, column of Vp)
      if (j > 0) {
        const int u0 = k / kW2Chunk;
        const int ntw = (nchunkW - u0) * j;
        for (int t = b + G * warp; t < ntw; t += nw) {
          const int u = u0 + t / j, q = t % j;
          const T* vq = out + (size_t)(s + q) * rows;
          T acc = T(0);
#pragma unroll
          for (int m = 0; m < kW2Chunk / 32; ++m) {
            const int i = u * kW2Chunk + m * 32 + lane;
            if (i >= k && i < rows) {
              const T vi = i < vr1 ? stage[i - vr0]
                                   : (i == k ? unit : __ldcg(bcol + i) / denom);
              acc += __ldcg(vq + i) * vi;
            }
          }
          acc = warp_sum(acc);
          if (lane == 0) w2part[(size_t)u * nb + q] = acc;
        }
      }
      PHASE(6);
      // W^T v of every live column, one stream over the grid: tasks (list
      // entry, segment of kSegVec 16-byte vectors a lane from vr0), dealt
      // round robin to the grid's warps, the list walked forward on even
      // steps and backward on odd ones (what a step reads last, the next
      // reads first, from the L2); a warp loads its next task while it
      // sums the current one; each partial to its slot (column, segment),
      // which the column's owner adds in segment order after B3
      const bool fwd = (k & 1) == 0;
      const int gw = b * kPanWarps + warp;
      unsigned long long pol_first, pol_normal;
      asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol_first));
      asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(pol_normal));
      for (int r0 = vr0; r0 < ldw; r0 += vrows) {
        const int r1 = min(ldw, r0 + vrows);
        if (r0 != vr0) stage_v(r0, r1);
        const V* vs = reinterpret_cast<const V*>(stage);
        const int ng = (r1 - r0) / VN;
        const int nsc = (r1 - r0 + kSeg - 1) / kSeg, sg0 = (r0 - vr0) / kSeg;
        const int ntask = nlive * nsc;
        // the task of dealt index i: its column and segment
        auto task = [&](int i, int& cl, int& sg) {
          const int t = fwd ? i : ntask - 1 - i;
          const int e = t / nsc;
          cl = live[e];
          sg = t - e * nsc;
        };
        // the first dealt index from i on, in steps of the grid's warps,
        // whose column is still live
        auto next_live = [&](int i) {
          for (; i < ntask; i += nw) {
            int cl, sg;
            task(i, cl, sg);
            if (!((chosen[cl >> 5] >> (cl & 31)) & 1u)) break;
          }
          return i;
        };
        // x[m] holds the current task's m-th vector until it is summed,
        // then the next task's: one task's loads stay in flight
        V x[kSegVec];
        int i = next_live(gw), cl = 0, sg = 0;
        if (i < ntask) {
          task(i, cl, sg);
          const V* col = reinterpret_cast<const V*>(W + (size_t)cl * ldw + r0);
          const unsigned long long pol =
              i < ntask - kKeepTasks ? pol_first : pol_normal;
#pragma unroll
          for (int m = 0; m < kSegVec; ++m) {
            const int g = sg * (kSeg / VN) + m * 32 + lane;
            x[m] = g < ng ? Vec16<T>::load(col + g, pol) : V{};
          }
        }
        while (i < ntask) {
          const int in = next_live(i + nw);
          int ncl = cl, nsgt = sg;
          if (in < ntask) task(in, ncl, nsgt);
          const V* ncol = reinterpret_cast<const V*>(W + (size_t)ncl * ldw + r0);
          const unsigned long long pol =
              in < ntask - kKeepTasks ? pol_first : pol_normal;
          T acc = T(0);
#pragma unroll
          for (int m = 0; m < kSegVec; ++m) {
            const int g = sg * (kSeg / VN) + m * 32 + lane;
            if (g < ng) acc = Vec16<T>::dot(x[m], vs[g], acc);
            const int gn = nsgt * (kSeg / VN) + m * 32 + lane;
            x[m] = (in < ntask && gn < ng) ? Vec16<T>::load(ncol + gn, pol) : V{};
          }
          acc = warp_sum(acc);
          if (lane == 0) w1part[(size_t)cl * nsegw + sg0 + sg] = acc;
          i = in;
          cl = ncl;
          sg = nsgt;
        }
      }
      PHASE(7);
      grid_sync();                                                    // B3
      PHASE(8);

      // ---- F[:, j], row k and the downdated norms of this block's
      // columns: Vp^T v by the last kMaxNB threads, and W^T v (its
      // partials added in segment order, from zero) and row k of a live
      // column by thread l, at once
      if (j > 0) {
        const int u0 = k / kW2Chunk;
        const int q = tid - (kPanThreads - kMaxNB);
        if (q >= 0 && q < j) {
          T sum = T(0);
#pragma unroll 4
          for (int u = u0; u < nchunkW; ++u) sum += __ldcg(w2part + (size_t)u * nb + q);
          w2s[q] = sum;
          vpk[q] = __ldcg(out + (size_t)(s + q) * rows + k);
        }
      }
      for (int l = tid; l < nloc; l += kPanThreads)
        if (lpos[l] > k) {
          wks[l] = __ldcg(colW(l) + k);
          const T* part = w1part + (size_t)(b + l * G) * nsegw;
          T a = T(0);
#pragma unroll 8
          for (int sg = 0; sg < nsg; ++sg) a += __ldcg(part + sg);
          w1s[l] = a;
        }
      if (tid == 0) vpk[j] = unit;
      __syncthreads();
      for (int l = warp; l < nloc; l += kPanWarps) {
        if (lpos[l] <= k) continue;         // chosen: its F row is frozen
        T* Fl = F + (size_t)l * nb;
        T f = T(0);
        if (tau != T(0)) {
          T d = T(0);
          for (int q = lane; q < j; q += 32) d += Fl[q] * w2s[q];
          d = warp_sum(d);
          f = tau * (w1s[l] - d);
        }
        if (lane == 0) Fl[j] = f;
        __syncwarp();
        T r = T(0);
        for (int q = lane; q <= j; q += 32) r += Fl[q] * vpk[q];
        r = warp_sum(r);
        if (lane == 0) {
          const T rowk = wks[l] - r;
          const T down = nrm[l] - mul_rn(rowk, rowk);
          nrm[l] = down < T(0) ? T(0) : down;
        }
      }
      __syncthreads();
      PHASE(9);
    }

    // ---- panel end: W -= Vp F^T on rows >= s of the live columns and
    // on the rows above the diagonal of the columns chosen in this panel;
    // the next panel's exact norms in the same sweep
    for (int q = tid; q < jn; q += kPanThreads)
      unitp[q] = (__ldcg(tauv + s + q) != T(0)) ? T(1) : T(0);
    const bool next = s + nb < nsteps;
    const int snext = s + nb;
    const int ld = jn | 1;                     // odd: no bank conflicts
    // as many 32-row slices of Vp a tile as the stage holds
    const int nsl = min(kStageT / (32 * ld), 8);
    T sq[kMaxQ];
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) sq[q] = T(0);
    for (int r0 = s; r0 < rows; r0 += 32 * nsl) {
      __syncthreads();
      for (int e = tid; e < 32 * nsl * jn; e += kPanThreads) {
        const int r = e / jn, q = e - r * jn, i = r0 + r, kq = s + q;
        T val = T(0);
        if (i < rows)
          val = (i > kq) ? __ldcg(out + (size_t)kq * rows + i)
                         : (i == kq ? unitp[q] : T(0));
        stage[r * ld + q] = val;
      }
      __syncthreads();
      for (int sl = 0; sl < nsl; ++sl) {
        const int i = r0 + 32 * sl + lane;
        const T* tr = stage + (32 * sl + lane) * ld;
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q) {
          const int l = warp + q * kPanWarps;
          if (l >= nloc) continue;
          const int p = lpos[l];
          if (p < s) continue;
          const bool live_col = p >= s + jn;
          if (i < rows && (live_col || i < p)) {
            const T* Fl = F + (size_t)l * nb;
            T a = T(0);
            for (int q2 = 0; q2 < jn; ++q2) a += tr[q2] * Fl[q2];
            T* w = colW(l) + i;
            const T x = __ldcg(w) - a;
            *w = x;
            if (live_col && i >= snext) sq[q] += x * x;
          }
        }
      }
    }
    __syncthreads();                           // every warp done with F
    if (next) {
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int l = warp + q * kPanWarps;
        if (l < nloc && lpos[l] >= s + jn) {
          const T v = warp_sum(sq[q]);
          if (lane == 0) nrm[l] = v;
        }
      }
    }
    for (int e = tid; e < nloc * nb; e += kPanThreads) F[e] = T(0);
    __syncthreads();
    PHASE(10);
  }

  // ---- the packed result: R and the diagonal of every chosen column (its
  // tail was written at its step), the whole column of every other ------
  for (int l = warp; l < nloc; l += kPanWarps) {
    const int p = lpos[l], cl = b + l * G;
    const T* src = colW(l);
    T* dst = out + (size_t)p * rows;
    const int n = p < nsteps ? p + 1 : rows;
#pragma unroll 4
    for (int i = lane; i < n; i += 32) dst[i] = __ldcg(src + i);
    if (lane == 0) perm[p] = cl;
  }
  if (b == 0)
    for (int q = nsteps + tid; q < kp; q += kPanThreads) tauv[q] = T(0);
#ifdef CPQR_PANELS_CLOCKS
  if (b == 0 && tid == 0)
    printf("cpqr_panels phase ns: start %lld P %lld B1 %lld pivot %lld A %lld "
           "B2 %lld refl %lld tails+w2 %lld w1 %lld B3 %lld C %lld end %lld\n",
           clk[11], clk[0], clk[1], clk[2], clk[3], clk[4], clk[5], clk[6],
           clk[7], clk[8], clk[9], clk[10]);
#endif
}

template <typename T>
int panels_run(const T* M, T* out, T* tauv, long long* perm, void* scratch,
               int* counter, const int* nsteps, int rows, int cols, int kp,
               int nb, int blocks, cudaStream_t stream) {
  if (blocks < 1 || blocks > cols || nb < 1 || nb > kMaxNB || cols > 65536 ||
      (cols + blocks - 1) / blocks > kPanWarps * kMaxQ)
    return (int)cudaErrorInvalidValue;
  const size_t smem = panels_shared_bytes(rows, cols, blocks, nb, sizeof(T));
  auto kernel = cpqr_panels<T>;
  cudaError_t err = cooperative_fit(kernel, kPanThreads, smem, blocks);
  if (err != cudaSuccess) return (int)err;
  // the barrier counter only grows within a launch: zeroed in stream
  // order before every launch (a memset node when captured)
  err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  unsigned char* sc = (unsigned char*)scratch;
  void* args[] = {&M,       &out,    &tauv, &perm, &sc, &counter,
                  &nsteps,  &rows,   &cols, &kp,   &nb};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks),
                                    dim3(kPanThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// C interface.  Launches on `stream`, allocates nothing, does not
// synchronise, and returns the first CUDA error (0 = success).
//
// M: (rows, cols) row-major, read only; out: (cols, rows) packed result;
// tauv: (kp,) and perm: (cols,) int64, both written in full; scratch:
// cpqr_panels_scratch_bytes(...) bytes; counter: one int32; nsteps: a
// pointer to one device int32 (clamped to [0, min(rows, cols)] on the
// device); nb: the panel width (<= 128); blocks <= min(SM count, cols),
// with cpqr_panels_shared_bytes(...) within the device's opt-in limit,
// ceil(cols / blocks) <= 128 and cols <= 65,536.
extern "C" int cpqr_panels_f32(const void* M, void* out, void* tauv,
                               void* perm, void* scratch, void* counter,
                               const void* nsteps, int rows, int cols, int kp,
                               int nb, int blocks, void* stream) {
  return panels_run<float>((const float*)M, (float*)out, (float*)tauv,
                           (long long*)perm, scratch, (int*)counter,
                           (const int*)nsteps, rows, cols, kp, nb, blocks,
                           (cudaStream_t)stream);
}

extern "C" int cpqr_panels_f64(const void* M, void* out, void* tauv,
                               void* perm, void* scratch, void* counter,
                               const void* nsteps, int rows, int cols, int kp,
                               int nb, int blocks, void* stream) {
  return panels_run<double>((const double*)M, (double*)out, (double*)tauv,
                            (long long*)perm, scratch, (int*)counter,
                            (const int*)nsteps, rows, cols, kp, nb, blocks,
                            (cudaStream_t)stream);
}

extern "C" long long cpqr_panels_shared_bytes(int rows, int cols, int blocks,
                                              int nb, int itemsize) {
  return (long long)panels_shared_bytes(rows, cols, blocks, nb,
                                        (size_t)itemsize);
}

extern "C" long long cpqr_panels_scratch_bytes(int rows, int cols, int blocks,
                                               int nb, int itemsize) {
  return (long long)panel_layout(rows, cols, blocks, nb, (size_t)itemsize)
      .total;
}
