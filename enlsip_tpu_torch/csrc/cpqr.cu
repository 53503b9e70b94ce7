// Column-pivoted Householder QR of one dense matrix, for NVIDIA Hopper.
//
// Replaces the Pallas kernel enlsip_tpu/ops/pallas_qr2.py::_kernel and
// computes the same function: exact trailing column norms every step,
// the first maximum as pivot, one Householder step, a host-supplied
// number of steps, and the result packed in place (R above the
// diagonal, the Householder beta on it, the reflector tail below) with
// tau and the pivot permutation beside it.
//
// Layout.  The matrix is held TRANSPOSED, bt[j * rows + i] = B[i][j], so
// every matrix column is contiguous and a warp reads it coalesced.  The
// TPU kernel kept the matrix resident in fast on-chip memory; a Hopper
// block has at most 227 KB of shared memory, so the matrix stays in
// global memory.  At the solver's sizes (a few MB) it is served from the
// 50 MB L2 after the first pass.
//
// Bound.  A step k must read the trailing (rows-k) x (cols-k) block for
// the dot products v^T B and again for the rank-1 update and the next
// step's norms, and write it once: about 3 * (rows-k) * (cols-k) *
// sizeof(T) bytes a step and 6 flops an element, i.e. 0.5 flop/byte — the
// work is bound by bytes (L2 bandwidth once resident), never by
// arithmetic.  On top of that comes a dependency across the whole matrix
// at every step: norms -> pivot -> swap -> reflector -> update.
//
// Design.  Two small kernels a step, enqueued back to back on one stream
// by the C function below; stream order supplies the dependency and the
// host never waits inside the factorization:
//
//   pivot_reflect (one block): reduces the per-block pivot candidates,
//     swaps columns k and piv, forms the reflector and packs column k.
//   update_norms (one warp a column): v^T b_j, the rank-1 update of
//     column j, and — fused into the same sweep over the column — the
//     squared norm of its rows > k for the NEXT step's pivot search, then
//     a per-block (value, index) maximum.
//
// Fusing the norm pass into the update removes one of the three full
// passes a step.  A chain of launches was chosen over one persistent
// cooperative kernel with grid-wide barriers: it needs no co-residency
// guarantee, no occupancy query and no cooperative-launch support, and a
// grid-wide barrier costs about as much as a launch on this card.
//
// Determinism.  No floating-point atomics.  Every sum is taken in a
// fixed order (lane-strided partial sums, then a butterfly over the
// warp, or a shared-memory tree over the block), and the pivot
// reductions compare (value, index) pairs and prefer the lower index, so
// ties resolve to the first maximum and two runs give the same bits.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kWarpsPerBlock = 4;     // columns per update_norms block
constexpr int kPivotThreads = 512;    // threads of the pivot_reflect block

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Does candidate (v2, i2) beat (v1, i1)?  Larger value, then lower index.
template <typename T>
__device__ __forceinline__ bool beats(T v2, int i2, T v1, int i1) {
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

// Step k's update of every column j > k by the reflector stored in
// column k, plus the squared norms of rows > k of the updated columns and
// each block's best (norm, column).  k = -1: no update, norms of whole
// columns (the pass before step 0).
template <typename T>
__global__ void update_norms(T* bt, const T* tauv, T* pval, int* pidx,
                             int rows, int cols, int k) {
  __shared__ T sval[kWarpsPerBlock];
  __shared__ int sidx[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = k + 1 + blockIdx.x * kWarpsPerBlock + warp;
  T nrm = T(-1);
  int idx = INT_MAX;
  if (j < cols) {
    T* col = bt + (size_t)j * rows;
    T acc = T(0);
    const T tau = (k >= 0) ? tauv[k] : T(0);
    if (tau != T(0)) {
      // v = (0, ..., 0, 1, tail): the tail sits below the diagonal of
      // column k.  Lane 0 alone touches element k of the column.
      const T* v = bt + (size_t)k * rows;
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
    nrm = warp_sum(acc);
    idx = j;
  }
  if (lane == 0) {
    sval[warp] = nrm;
    sidx[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T bv = sval[0];
    int bi = sidx[0];
    for (int w = 1; w < kWarpsPerBlock; ++w)
      if (beats(sval[w], sidx[w], bv, bi)) {
        bv = sval[w];
        bi = sidx[w];
      }
    pval[blockIdx.x] = bv;
    pidx[blockIdx.x] = bi;
  }
}

// Step k's pivot choice, column swap, reflector and packed column.
template <typename T>
__global__ void pivot_reflect(T* bt, T* tauv, int* perm, const T* pval,
                              const int* pidx, int npart, int rows, int cols,
                              int k) {
  __shared__ T sval[kPivotThreads];
  __shared__ int sidx[kPivotThreads];
  __shared__ T sdenom;
  const int tid = threadIdx.x;

  // ---- pivot: first maximum over the per-block candidates -------------
  T bv = T(-1);
  int bi = INT_MAX;
  for (int p = tid; p < npart; p += kPivotThreads)
    if (beats(pval[p], pidx[p], bv, bi)) {
      bv = pval[p];
      bi = pidx[p];
    }
  sval[tid] = bv;
  sidx[tid] = bi;
  __syncthreads();
  for (int o = kPivotThreads / 2; o > 0; o >>= 1) {
    if (tid < o && beats(sval[tid + o], sidx[tid + o], sval[tid], sidx[tid])) {
      sval[tid] = sval[tid + o];
      sidx[tid] = sidx[tid + o];
    }
    __syncthreads();
  }
  int piv = sidx[0];
  if (piv < k || piv >= cols) piv = k;   // no finite candidate: stay put
  __syncthreads();

  // ---- swap columns k <-> piv (whole columns, R part included) --------
  T* ck = bt + (size_t)k * rows;
  if (piv != k) {
    T* cp = bt + (size_t)piv * rows;
    for (int i = tid; i < rows; i += kPivotThreads) {
      const T a = ck[i];
      ck[i] = cp[i];
      cp[i] = a;
    }
    if (tid == 0) {
      const int a = perm[k];
      perm[k] = perm[piv];
      perm[piv] = a;
    }
  }
  __syncthreads();

  // ---- Householder reflector of rows >= k of column k -----------------
  T acc = T(0);
  for (int i = k + tid; i < rows; i += kPivotThreads) acc += ck[i] * ck[i];
  sval[tid] = acc;
  __syncthreads();
  for (int o = kPivotThreads / 2; o > 0; o >>= 1) {
    if (tid < o) sval[tid] += sval[tid + o];
    __syncthreads();
  }
  if (tid == 0) {
    const T alpha = ck[k];
    const T signorm = sqrt(sval[0]);
    const T beta = (alpha >= T(0)) ? -signorm : signorm;
    const T denom = alpha - beta;
    const bool safe = fabs(denom) > T(0);
    // A zero tail gives tau = 0, v = 0 and keeps alpha on the diagonal.
    tauv[k] = (safe && beta != T(0)) ? (beta - alpha) / beta : T(0);
    ck[k] = safe ? beta : alpha;
    sdenom = safe ? denom : T(1);
  }
  __syncthreads();
  const T denom = sdenom;
  for (int i = k + 1 + tid; i < rows; i += kPivotThreads) ck[i] = ck[i] / denom;
}

template <typename T>
int cpqr_run(T* bt, T* tauv, int* perm, T* pval, int* pidx, int rows, int cols,
             int nsteps, cudaStream_t stream) {
  const int kmax = rows < cols ? rows : cols;
  if (nsteps > kmax) nsteps = kmax;
  if (nsteps > 0) {
    int nblk = (cols + kWarpsPerBlock - 1) / kWarpsPerBlock;
    update_norms<T><<<nblk, kWarpsPerBlock * 32, 0, stream>>>(
        bt, tauv, pval, pidx, rows, cols, -1);
    int npart = nblk;
    for (int k = 0; k < nsteps; ++k) {
      pivot_reflect<T><<<1, kPivotThreads, 0, stream>>>(
          bt, tauv, perm, pval, pidx, npart, rows, cols, k);
      const int ntrail = cols - k - 1;
      if (ntrail > 0) {
        nblk = (ntrail + kWarpsPerBlock - 1) / kWarpsPerBlock;
        update_norms<T><<<nblk, kWarpsPerBlock * 32, 0, stream>>>(
            bt, tauv, pval, pidx, rows, cols, k);
        npart = nblk;
      }
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface.  bt: (cols, rows) matrix, transposed, overwritten with the
// packed result; tauv: (kp,) zero-filled by the caller; perm: (cols,)
// int32 holding 0..cols-1; pval/pidx: scratch of ceil(cols / 4) entries.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError().
extern "C" int cpqr_f32(void* bt, void* tauv, void* perm, void* pval,
                        void* pidx, int rows, int cols, int nsteps,
                        void* stream) {
  return cpqr_run<float>((float*)bt, (float*)tauv, (int*)perm, (float*)pval,
                         (int*)pidx, rows, cols, nsteps, (cudaStream_t)stream);
}

extern "C" int cpqr_f64(void* bt, void* tauv, void* perm, void* pval,
                        void* pidx, int rows, int cols, int nsteps,
                        void* stream) {
  return cpqr_run<double>((double*)bt, (double*)tauv, (int*)perm,
                          (double*)pval, (int*)pidx, rows, cols, nsteps,
                          (cudaStream_t)stream);
}

extern "C" const char* cpqr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int cpqr_scratch_entries(int cols) {
  return (cols + kWarpsPerBlock - 1) / kWarpsPerBlock;
}
