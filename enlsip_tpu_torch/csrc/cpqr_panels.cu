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
// (5000 x 4998) the reads come to about 1.7e11 bytes at float32, ~50 ms
// over the HBM rate, less once the trailing block fits the 50 MB L2; and
// every step is a chain of card-wide dependencies (pivot -> reflector ->
// F column -> downdated norms), so the latency of a step adds to that.
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
//           tails, staged v in shared memory, formed Vp^T v in 512-row
//           partials over the grid's warps and its live columns' W^T v,
//           tasks of (column, 8 16-byte loads a lane) spread over its
//           warps, a column's partials added in row order.
//     After B3 each block sums those partials, forms F[:, j], row k of the
//     updated matrix and the downdated norms of its own columns; the next
//     step's candidates follow without a barrier.
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
// added in slice order; bcol's sums over reflectors by fixed residues
// mod 16, added in warp order.  Two launches give the same bits, and so
// do two block counts.
//
// Measured (chip_panels_phases.py and chip_smoke.py's b1_panels on an
// H100, PERF.md): the W^T v sweep takes about twice its bytes' time at
// the HBM and L2 rates, and the rest of a step, about 25 us at cr5000,
// is the latency of its barriers and dependent loads.
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
constexpr int kStageBytes = 8 * kTile * (kTile + 1);   // the stage
constexpr int kMaxQ = 8;                         // own columns of a warp
constexpr int kSegVec = 8;                       // vectors a lane, W^T v task
constexpr int kMaxSeg = 8;                       // W^T v tasks a column, chunk
// values of type T the stage holds, and rows of v staged at once (a
// multiple of 128: 8192 at float32, 4096 at float64)
template <typename T>
__host__ __device__ constexpr int stage_len() { return kStageBytes / sizeof(T); }
template <typename T>
__host__ __device__ constexpr int vchunk_rows() {
  return stage_len<T>() / 128 * 128 < kMaxSeg * kSegVec * 32 * (16 / (int)sizeof(T))
             ? stage_len<T>() / 128 * 128
             : kMaxSeg * kSegVec * 32 * (16 / (int)sizeof(T));
}
static_assert(32 * (kMaxNB + 1) <= stage_len<double>() &&
              kPanThreads <= stage_len<double>(), "stage too small");
static_assert(vchunk_rows<float>() <= kMaxSeg * kSegVec * 32 * 4 &&
              vchunk_rows<double>() <= kMaxSeg * kSegVec * 32 * 2,
              "too few segments");

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// 16-byte vectors of the working matrix's columns (padded to a multiple of
// 4 rows, so every column starts 16-byte aligned): products summed in
// component order.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
    acc += a.x * b.x; acc += a.y * b.y; acc += a.z * b.z; acc += a.w * b.w;
    return acc;
  }
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
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

// Byte offsets of the scratch buffer's parts (one allocation the wrapper
// makes): the working matrix W (cols, padded rows), bcol (rows), the
// 32-row sums of squares, the Vp^T v partials (512-row slices x nb), and
// the blocks' pivot candidates (value, F row, position, column).
struct PanelLayout {
  size_t W, bcol, sumsq, w2part, cval, cF, cpos, ccol, total;
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

// Dynamic shared memory of a block: the stage, the F rows, norms, W^T v,
// row k and W^T v partials of its columns, four panel-width vectors, its
// columns' positions and its live columns.
__host__ __device__ inline size_t panels_shared_bytes(int rows, int cols,
                                                      int blocks, int nb,
                                                      size_t itemsize) {
  (void)rows;
  const size_t nloc = (size_t)(cols + blocks - 1) / blocks;
  return kStageBytes + (nloc * (nb + 3 + kMaxSeg) + 4 * (size_t)nb) * itemsize +
         2 * nloc * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kPanThreads, 1)
cpqr_panels(const T* __restrict__ M, T* out, T* tauv,
            long long* __restrict__ perm, unsigned char* scratch,
            int* counter, const int* nsteps_p, int rows, int cols, int kp,
            int nb) {
  using V = typename Vec16<T>::type;
  constexpr int VN = Vec16<T>::n;
  const int nsteps = step_count(nsteps_p, rows, cols);
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = G * kPanWarps;                  // warps of the grid
  const int nlocmax = (cols + G - 1) / G;
  const int nloc = (cols - b + G - 1) / G;       // columns b, b + G, ...
  const int ldw = padded_rows(rows);
  const int nchunk32 = (rows + 31) / 32;
  const int nchunkW = (rows + kW2Chunk - 1) / kW2Chunk;

  const PanelLayout L = panel_layout(rows, cols, G, nb, sizeof(T));
  T* W = reinterpret_cast<T*>(scratch + L.W);
  T* bcol = reinterpret_cast<T*>(scratch + L.bcol);
  T* sumsq = reinterpret_cast<T*>(scratch + L.sumsq);
  T* w2part = reinterpret_cast<T*>(scratch + L.w2part);
  T* cval = reinterpret_cast<T*>(scratch + L.cval);
  T* cF = reinterpret_cast<T*>(scratch + L.cF);
  int* cpos = reinterpret_cast<int*>(scratch + L.cpos);
  int* ccol = reinterpret_cast<int*>(scratch + L.ccol);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kStageT = stage_len<T>(), kVChunk = vchunk_rows<T>();
  T* stage = reinterpret_cast<T*>(smem_raw);     // (kStageT,), 16-byte aligned
  T* F = stage + kStageT;                        // (nlocmax, nb)
  T* nrm = F + (size_t)nlocmax * nb;             // (nlocmax,)
  T* w1s = nrm + nlocmax;                        // (nlocmax,) W^T v
  T* wks = w1s + nlocmax;                        // (nlocmax,) row k of W
  T* Fc = wks + nlocmax;                         // (nb,) the winner's F row
  T* w2s = Fc + nb;                              // (nb,) Vp^T v
  T* vpk = w2s + nb;                             // (nb,) row k of Vp
  T* unitp = vpk + nb;                           // (nb,) Vp's unit diagonal
  T* w1part = unitp + nb;                        // (nlocmax, kMaxSeg)
  int* lpos = reinterpret_cast<int*>(w1part + (size_t)nlocmax * kMaxSeg);
  int* llive = lpos + nlocmax;                   // (nlocmax,) live columns
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
      // below kVChunk rows)
      const int vr0 = k & ~127;
      auto stage_v = [&](int r0, int r1) {
        __syncthreads();
        for (int i = r0 + tid; i < r1; i += kPanThreads)
          stage[i - r0] = (i < k || i >= rows)
                              ? T(0)
                              : (i == k ? unit : __ldcg(bcol + i) / denom);
        __syncthreads();
      };
      int vr1 = min(ldw, vr0 + kVChunk);
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
      // W^T v of this block's live columns: v staged in shared memory by
      // chunks; in a chunk, tasks of (live column, segment of kSegVec
      // vectors a lane) spread over the warps; a column's segments added
      // in row order
      if (warp == 0) {
        int n = 0;
        for (int base = 0; base < nloc; base += 32) {
          const int l = base + lane;
          const bool is_live = l < nloc && lpos[l] > k;
          const unsigned mask = __ballot_sync(0xffffffffu, is_live);
          if (is_live) llive[n + __popc(mask & ((1u << lane) - 1))] = l;
          n += __popc(mask);
        }
        if (lane == 0) s_nlive = n;
      }
      for (int l = tid; l < nloc; l += kPanThreads) w1s[l] = T(0);
      constexpr int kSeg = kSegVec * 32 * VN;    // rows of a task
      for (int r0 = vr0; r0 < ldw; r0 += kVChunk) {
        const int r1 = min(ldw, r0 + kVChunk);
        if (r0 != vr0) stage_v(r0, r1);
        __syncthreads();
        const V* vs = reinterpret_cast<const V*>(stage);
        const int ng = (r1 - r0) / VN;
        const int nseg = (r1 - r0 + kSeg - 1) / kSeg;
        const int ntask = s_nlive * nseg;
        for (int t = warp; t < ntask; t += kPanWarps) {
          const int li = t / nseg, sg = t - li * nseg;
          const V* col = reinterpret_cast<const V*>(colW(llive[li]) + r0);
          T acc = T(0);
#pragma unroll
          for (int m = 0; m < kSegVec; ++m) {
            const int g = sg * (kSeg / VN) + m * 32 + lane;
            if (g < ng) acc = Vec16<T>::dot(__ldcg(col + g), vs[g], acc);
          }
          acc = warp_sum(acc);
          if (lane == 0) w1part[li * kMaxSeg + sg] = acc;
        }
        __syncthreads();
        for (int li = tid; li < s_nlive; li += kPanThreads) {
          T a = w1s[llive[li]];
          for (int sg = 0; sg < nseg; ++sg) a += w1part[li * kMaxSeg + sg];
          w1s[llive[li]] = a;
        }
      }
      PHASE(7);
      grid_sync();                                                    // B3
      PHASE(8);

      // ---- F[:, j], row k and the downdated norms of this block's columns
      if (j > 0) {
        const int u0 = k / kW2Chunk;
        for (int q = tid; q < j; q += kPanThreads) {
          T sum = T(0);
#pragma unroll 4
          for (int u = u0; u < nchunkW; ++u) sum += __ldcg(w2part + (size_t)u * nb + q);
          w2s[q] = sum;
          vpk[q] = __ldcg(out + (size_t)(s + q) * rows + k);
        }
      }
      for (int l = tid; l < nloc; l += kPanThreads)
        if (lpos[l] > k) wks[l] = __ldcg(colW(l) + k);
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
  if (blocks < 1 || blocks > cols || nb < 1 || nb > kMaxNB ||
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
// with cpqr_panels_shared_bytes(...) within the device's opt-in limit and
// ceil(cols / blocks) <= 128.
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
