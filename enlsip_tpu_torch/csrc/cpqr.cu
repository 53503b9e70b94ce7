// Column-pivoted Householder QR of one dense matrix, for NVIDIA Hopper.
//
// Replaces the Pallas kernel enlsip_tpu/ops/pallas_qr2.py::_kernel and
// computes the same function: exact trailing column norms every step,
// the first maximum as pivot, one Householder step, a number of steps
// read from device memory (the TPU kernel takes it in SMEM) and clamped
// to min(rows, cols), and the result packed (R above the diagonal, the
// Householder beta on it, the reflector tail below) as a (cols, rows)
// buffer with tau and the pivot permutation beside it.
//
// Bound.  A step k does 6 flops on each element of the trailing
// (rows-k) x (cols-k) block at half a flop a byte, so by the card's
// rates the work is small; what bounds the factorization is the
// dependency across the whole matrix at every step, norms -> pivot ->
// reflector -> update, paid min(rows, cols) times in sequence.  The
// design question is what one such card-wide round trip costs.
//
// Two routes, chosen by the wrapper from shape and device properties
// (ops/cpqr_hopper.py::b1_route): this file's resident route, the
// counterpart of the TPU kernel, for a matrix that fits the card's shared
// memory; csrc/cpqr_panels.cu, the JAX package's geqp3 panel loop with
// downdated norms, for one that does not, as the TPU takes that loop above
// its VMEM gate.
//
// RESIDENT (cpqr_resident): what the TPU kernel really kept was the
// whole matrix in fast memory for all steps.  One block cannot on this
// card, but the card can: one persistent cooperative launch of at most
// one block an SM, block b owning columns b, b + G, b + 2G, ... in its
// dynamic shared memory.  It reads M row-major once, runs every step
// there and writes each packed column once.
//   * Columns never move between blocks.  A pivot swap is bookkeeping:
//     every block keeps the same position <-> column maps in shared
//     memory and applies the same exchange.  A column is written to its
//     final position when it is chosen, or at the end if it never is.
//   * One grid-wide barrier a step.  After its update a block publishes
//     its best (norm, position) and that candidate column to its slot in
//     global memory (two slots by step parity, served from L2); after
//     the barrier every block reduces the candidates itself, reads the
//     winner's column, forms the reflector redundantly (same arithmetic
//     in the same order, so the same bits in every block) and updates
//     its own columns, fusing the next step's norms into that sweep.
//     The winner's squared norm IS the reflector's norm: it is not
//     summed again.
//   * The barrier is an arrive / wait pair on a counter in L2 (release
//     fence + atomic add; acquire-load spin), so a block writes its
//     packed column between arriving and waiting.  The measured cost of
//     this barrier and of cooperative-groups grid.sync() is printed by
//     chip_smoke.py (grid_barrier_us) and recorded in PERF.md.
//   * Pivot ties go to the lowest current POSITION (through the inverse
//     map), as the first maximum of the swapped matrix would.
//
// Determinism.  No floating-point atomics.  A column's dot product and
// norm are summed by one warp in a fixed order (lane-strided partial
// sums, then a butterfly), whichever block owns the column and
// however many blocks the card gave; pivot reductions compare (value,
// position) pairs and prefer the lower position.  Two launches give the
// same bits, and so do two block counts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>

#include "cpqr_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cpqr_common;

constexpr int kResThreads = 512;      // threads of a cpqr_resident block

// ------------------------------------------------------ resident route

// Shared memory of a resident block: its columns, the reflector, the
// norms of its columns and the two position <-> column maps.
__host__ __device__ inline size_t resident_shared_bytes(int rows, int cols,
                                                        int blocks,
                                                        size_t itemsize) {
  const size_t nloc = (size_t)(cols + blocks - 1) / blocks;
  return (nloc * rows + rows + nloc) * itemsize + 2 * (size_t)cols * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kResThreads, 1)
cpqr_resident(const T* __restrict__ M, T* __restrict__ out,
              T* __restrict__ tauv, long long* __restrict__ perm, T* cand,
              T* cval, int* cpos, int* counter, const int* nsteps_p, int rows,
              int cols, int kp) {
  const int nsteps = step_count(nsteps_p, rows, cols);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_val;
  __shared__ int s_blk, s_col;
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kResThreads / 32;
  const int nlocmax = (cols + G - 1) / G;
  const int nloc = (cols - b + G - 1) / G;      // columns b, b + G, ...
  T* colbuf = reinterpret_cast<T*>(smem_raw);   // (nloc, rows)
  T* v = colbuf + (size_t)nlocmax * rows;       // (rows,) reflector
  T* nrm = v + rows;                            // (nlocmax,)
  int* pos2col = reinterpret_cast<int*>(nrm + nlocmax);
  int* col2pos = pos2col + cols;

  for (int t = tid; t < nloc * rows; t += kResThreads) {
    const int i = t / nloc, l = t - i * nloc;
    colbuf[(size_t)l * rows + i] = M[(size_t)i * cols + b + l * G];
  }
  for (int c = tid; c < cols; c += kResThreads) {
    pos2col[c] = c;
    col2pos[c] = c;
  }
  __syncthreads();
  for (int l = warp; l < nloc; l += kWarps) {
    const T* col = colbuf + (size_t)l * rows;
    T acc = T(0);
    for (int i = lane; i < rows; i += 32) acc += col[i] * col[i];
    acc = warp_sum(acc);
    if (lane == 0) nrm[l] = acc;
  }
  __syncthreads();

  // The owner of the column chosen at step kk writes it to its packed
  // position: R part and diagonal from its copy, the tail from v.
  int chosen = 0;
  auto write_packed = [&](int kk) {
    const T* col = colbuf + (size_t)(chosen / G) * rows;
    T* dst = out + (size_t)kk * rows;
    for (int i = tid; i < rows; i += kResThreads)
      dst[i] = (i <= kk) ? col[i] : v[i];
  };

  for (int k = 0; k < nsteps; ++k) {
    // ---- publish this block's candidate for step k, then arrive -------
    const int par = k & 1;
    int best;        // this block's offer (local column), -1 for none
    {
      // Every warp finds it for itself (no barrier to hand it round): the
      // best live column by (norm, position); a block whose live columns
      // all have NaN norms offers its lowest position with value -1, so
      // that position k always has an offer.
      T bv = T(-1);
      int bi = INT_MAX, bl = -1, fp = INT_MAX, fl = -1;
      for (int l = lane; l < nloc; l += 32) {
        const int p = col2pos[b + l * G];
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
      if (tid == 0) {
        cval[par * G + b] = bv;
        cpos[par * G + b] = bi;
      }
      best = bl;
    }
    if (best >= 0) {
      const T* col = colbuf + (size_t)best * rows;
      T* slot = cand + ((size_t)par * G + b) * rows;
      for (int i = k + tid; i < rows; i += kResThreads) slot[i] = col[i];
    }
    __syncthreads();
    if (tid == 0) grid_arrive(counter);

    // ---- packed column k - 1, written while the others arrive ---------
    if (k > 0 && chosen % G == b) write_packed(k - 1);

    // ---- pivot: first maximum over the blocks' candidates -------------
    if (warp == 0) {
      if (lane == 0) grid_wait(counter, (k + 1) * G);
      __syncwarp();
      T bv = T(-1);
      int bi = INT_MAX, bb = 0;
      for (int p = lane; p < G; p += 32) {
        const T cv = __ldcg(cval + par * G + p);
        const int ci = __ldcg(cpos + par * G + p);
        if (beats(cv, ci, bv, bi)) {
          bv = cv;
          bi = ci;
          bb = p;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const T ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        const int ob = __shfl_xor_sync(0xffffffffu, bb, o);
        if (beats(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
          bb = ob;
        }
      }
      if (lane == 0) {
        if (bi < k || bi >= cols) bi = k;   // unreachable: k always has an offer
        // the exchange of positions k and piv, the same in every block
        const int c = pos2col[bi], ck = pos2col[k];
        pos2col[k] = c;
        pos2col[bi] = ck;
        col2pos[ck] = bi;
        col2pos[c] = k;
        s_val = bv;
        s_blk = bb;
        s_col = c;
      }
    }
    __syncthreads();

    // ---- Householder reflector of the winner, in every block ----------
    const T* cw = cand + ((size_t)par * G + s_blk) * rows;
    const T alpha = __ldcg(cw + k);
    const T signorm = sqrt(s_val);
    const T beta = (alpha >= T(0)) ? -signorm : signorm;
    const T den = alpha - beta;
    const bool safe = fabs(den) > T(0);
    // A zero tail gives tau = 0, v = 0 and keeps alpha on the diagonal.
    const T tau = (safe && beta != T(0)) ? (beta - alpha) / beta : T(0);
    const T denom = safe ? den : T(1);
    for (int i = k + 1 + tid; i < rows; i += kResThreads)
      v[i] = __ldcg(cw + i) / denom;
    chosen = s_col;
    const bool owner = (chosen % G == b);
    __syncthreads();
    if (owner && tid == 0) {
      colbuf[(size_t)(chosen / G) * rows + k] = safe ? beta : alpha;
      tauv[k] = tau;
    }

    // ---- update of the live columns and their next norms --------------
    for (int l = warp; l < nloc; l += kWarps) {
      if (col2pos[b + l * G] <= k) continue;        // chosen already
      T* col = colbuf + (size_t)l * rows;
      T acc = T(0);
      if (tau != T(0)) {
        T dot = (lane == 0) ? col[k] : T(0);
        for (int i = k + 1 + lane; i < rows; i += 32) dot += v[i] * col[i];
        const T s = tau * warp_sum(dot);
        for (int i = k + 1 + lane; i < rows; i += 32) {
          const T x = col[i] - s * v[i];
          col[i] = x;
          acc += x * x;
        }
        if (lane == 0) col[k] -= s;
      } else {
        for (int i = k + 1 + lane; i < rows; i += 32) acc += col[i] * col[i];
      }
      acc = warp_sum(acc);
      if (lane == 0) nrm[l] = acc;
    }
    __syncthreads();

    if (k + 1 == nsteps && owner) write_packed(k);   // the last one
  }

  // ---- the columns never chosen, tau past nsteps, and perm ------------
  for (int l = warp; l < nloc; l += kWarps) {
    const int p = col2pos[b + l * G];
    if (p < nsteps) continue;
    const T* col = colbuf + (size_t)l * rows;
    T* dst = out + (size_t)p * rows;
    for (int i = lane; i < rows; i += 32) dst[i] = col[i];
  }
  if (b == 0) {
    for (int c = tid; c < cols; c += kResThreads) perm[c] = pos2col[c];
    for (int k = nsteps + tid; k < kp; k += kResThreads) tauv[k] = T(0);
  }
}

template <typename T>
int resident_run(const T* M, T* out, T* tauv, long long* perm, T* cand, T* cval,
                 int* cpos, int* counter, const int* nsteps, int rows,
                 int cols, int kp, int blocks, cudaStream_t stream) {
  if (blocks < 1 || blocks > cols) return (int)cudaErrorInvalidValue;
  const size_t smem = resident_shared_bytes(rows, cols, blocks, sizeof(T));
  auto kernel = cpqr_resident<T>;
  cudaError_t err = cooperative_fit(kernel, kResThreads, smem, blocks);
  if (err != cudaSuccess) return (int)err;
  // The barrier counter only grows within a launch; zeroing it in stream
  // order before every launch (a memset node when the launch is
  // captured) gives every replay of a graph a clean start.
  err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&M,    &out,     &tauv,   &perm, &cand, &cval,
                  &cpos, &counter, &nsteps, &rows, &cols, &kp};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks),
                                    dim3(kResThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `iters` grid-wide barriers and nothing else, to time one: the arrive /
// wait pair above (CG = false) or cooperative-groups grid.sync().
template <bool CG>
__global__ void __launch_bounds__(kResThreads, 1)
barrier_probe(int* counter, int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < iters; ++it) {
    if (CG) {
      grid.sync();
    } else {
      __syncthreads();
      if (threadIdx.x == 0) {
        grid_arrive(counter);
        grid_wait(counter, (it + 1) * (int)gridDim.x);
      }
      __syncthreads();
    }
  }
}

}  // namespace

// C interface.  Every function launches on `stream`, allocates nothing,
// does not synchronise, and returns the first CUDA error (0 = success).
//
// The step count is a pointer to one device int32 (clamped to
// [0, min(rows, cols)] on the device).
//
// Resident route.  M: (rows, cols) row-major, read only; out: (cols, rows)
// packed result; tauv: (kp,) and perm: (cols,) int64, both written in
// full; scratch: cand (2, blocks, rows), cval (2, blocks), cpos (2, blocks)
// int32, counter one int32.  blocks <= min(SM count, cols), with
// cpqr_resident_shared_bytes(rows, cols, blocks, itemsize) within the
// device's opt-in limit.
extern "C" int cpqr_resident_f32(const void* M, void* out, void* tauv,
                                 void* perm, void* cand, void* cval,
                                 void* cpos, void* counter, const void* nsteps,
                                 int rows, int cols, int kp, int blocks,
                                 void* stream) {
  return resident_run<float>((const float*)M, (float*)out, (float*)tauv,
                             (long long*)perm, (float*)cand, (float*)cval,
                             (int*)cpos, (int*)counter, (const int*)nsteps,
                             rows, cols, kp, blocks, (cudaStream_t)stream);
}

extern "C" int cpqr_resident_f64(const void* M, void* out, void* tauv,
                                 void* perm, void* cand, void* cval,
                                 void* cpos, void* counter, const void* nsteps,
                                 int rows, int cols, int kp, int blocks,
                                 void* stream) {
  return resident_run<double>((const double*)M, (double*)out, (double*)tauv,
                              (long long*)perm, (double*)cand, (double*)cval,
                              (int*)cpos, (int*)counter, (const int*)nsteps,
                              rows, cols, kp, blocks, (cudaStream_t)stream);
}

extern "C" long long cpqr_resident_shared_bytes(int rows, int cols, int blocks,
                                                int itemsize) {
  return (long long)resident_shared_bytes(rows, cols, blocks, (size_t)itemsize);
}

// The current device's SM count, opt-in shared memory a block (bytes) and
// whether it takes cooperative launches.
extern "C" int cpqr_device_limits(int* sms, int* shared_optin, int* coop) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(shared_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  return (int)err;
}

// `iters` grid-wide barriers of `blocks` blocks: kind 0 the arrive / wait
// pair of the resident kernel, kind 1 cooperative-groups grid.sync().
extern "C" int cpqr_barrier_probe(int kind, int blocks, int iters,
                                  void* counter, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int* ctr = (int*)counter;
  cudaError_t err = cudaMemsetAsync(ctr, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&ctr, &iters};
  void* kernel = kind == 0 ? (void*)barrier_probe<false>
                           : (void*)barrier_probe<true>;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kResThreads),
                                    args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* cpqr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
