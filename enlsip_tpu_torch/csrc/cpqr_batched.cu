// Column-pivoted Householder QR of a BATCH of tiny matrices, for NVIDIA
// Hopper.
//
// Replaces the Pallas kernel enlsip_tpu/ops/pallas_batched_qr.py::_kernel
// and computes the same function per lane: for k = 0 .. kmax-1 the exact
// squared norms of rows >= k of columns >= k, the first maximum as pivot,
// the column (and perm) swap, one Householder reflector with
// sign = (alpha >= 0 ? 1 : -1), its application to the columns > k only,
// and column k packed in place (R above the diagonal, beta on it, the
// reflector tail below).  All kmax steps run: a step on a zero column
// gives tau = 0 and changes nothing, so masked buffers need no step count.
//
// Bound.  A lane's matrix is at most 2048 elements; a batch of 10,000
// 40 x 10 float32 matrices is 1.6 MB in and 1.6 MB out, a few microseconds
// at the memory rate, and 6 flops an element a step is far below the
// arithmetic peak.  What the card actually waits for is the sequential
// pivot -> reflector -> update chain of each lane, so the design gives
// every lane its own thread and lets the batch fill the card.
//
// Design.  One thread per lane, working in place on a structure-of-arrays
// buffer a[(j * rows + i) * B + lane] = M[lane][i][j]: consecutive threads
// touch consecutive addresses, so every access of a warp is one coalesced
// line, and a lane's working set (<= 8 KB float32) is served from L1/L2
// after the first touch.  Every sum runs in a fixed order inside its
// thread: no atomics, no cross-thread reduction, no synchronisation, and
// the bits do not depend on the schedule.  Threads past the batch size
// return at once, so any B (1, 513, 10,000) is right without padding.
// perm is int32 and indexed directly; tau and perm are separate outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // lanes per block: many small blocks spread
                               // a few thousand lanes over all 132 SMs

template <typename T>
__global__ void cpqr_batched_kernel(T* __restrict__ a, T* __restrict__ tauv,
                                    int* __restrict__ perm, int rows, int cols,
                                    int kmax, int nbatch) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nbatch) return;
  const size_t S = (size_t)nbatch;         // stride between a lane's elements
  T* A = a + lane;                         // M[i][j] at A[(j * rows + i) * S]
  int* P = perm + lane;                    // perm[j] at P[j * S]
  T* TAU = tauv + lane;                    // tau[k] at TAU[k * S]
#define EL(i, j) A[((size_t)(j) * rows + (i)) * S]

  for (int j = 0; j < cols; ++j) P[(size_t)j * S] = j;

  for (int k = 0; k < kmax; ++k) {
    // ---- exact trailing norms, first maximum ---------------------------
    T best = T(-1);
    int piv = k;
    for (int j = k; j < cols; ++j) {
      T s = T(0);
      for (int i = k; i < rows; ++i) {
        const T x = EL(i, j);
        s += x * x;
      }
      if (s > best) {          // strict: ties keep the lowest index
        best = s;
        piv = j;
      }
    }
    // ---- swap columns k <-> piv (whole columns) and their perm entries --
    if (piv != k) {
      for (int i = 0; i < rows; ++i) {
        const T t = EL(i, k);
        EL(i, k) = EL(i, piv);
        EL(i, piv) = t;
      }
      const int t = P[(size_t)k * S];
      P[(size_t)k * S] = P[(size_t)piv * S];
      P[(size_t)piv * S] = t;
    }
    // ---- Householder reflector on rows >= k of column k ----------------
    const T alpha = EL(k, k);
    T s = T(0);
    for (int i = k; i < rows; ++i) {
      const T x = EL(i, k);
      s += x * x;
    }
    const T signorm = sqrt(s);
    const T beta = (alpha >= T(0)) ? -signorm : signorm;
    T denom = alpha - beta;
    const bool safe = fabs(denom) > T(0);
    if (!safe) denom = T(1);
    const T tau = (safe && beta != T(0)) ? (beta - alpha) / beta : T(0);
    const T vk = safe ? T(1) : T(0);
    for (int i = k + 1; i < rows; ++i) EL(i, k) = EL(i, k) / denom;
    // ---- H = I - tau v v^T on the columns > k ---------------------------
    if (tau != T(0)) {
      for (int j = k + 1; j < cols; ++j) {
        T dot = vk * EL(k, j);
        for (int i = k + 1; i < rows; ++i) dot += EL(i, k) * EL(i, j);
        const T w = tau * dot;
        EL(k, j) -= w * vk;
        for (int i = k + 1; i < rows; ++i) EL(i, j) -= w * EL(i, k);
      }
    }
    EL(k, k) = safe ? beta : alpha;
    TAU[(size_t)k * S] = tau;
  }
#undef EL
}

template <typename T>
int cpqr_batched_run(T* a, T* tauv, int* perm, int rows, int cols, int nbatch,
                     cudaStream_t stream) {
  const int kmax = rows < cols ? rows : cols;
  if (nbatch > 0 && kmax > 0) {
    const int nblk = (nbatch + kThreads - 1) / kThreads;
    cpqr_batched_kernel<T><<<nblk, kThreads, 0, stream>>>(a, tauv, perm, rows,
                                                         cols, kmax, nbatch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface.  a: (cols, rows, B) structure-of-arrays buffer, overwritten
// with the packed result; tauv: (kmax, B); perm: (cols, B) int32, filled
// here.  Launches one kernel on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
extern "C" int cpqr_batched_f32(void* a, void* tauv, void* perm, int rows,
                                int cols, int nbatch, void* stream) {
  return cpqr_batched_run<float>((float*)a, (float*)tauv, (int*)perm, rows,
                                 cols, nbatch, (cudaStream_t)stream);
}

extern "C" int cpqr_batched_f64(void* a, void* tauv, void* perm, int rows,
                                int cols, int nbatch, void* stream) {
  return cpqr_batched_run<double>((double*)a, (double*)tauv, (int*)perm, rows,
                                  cols, nbatch, (cudaStream_t)stream);
}

extern "C" const char* cpqr_batched_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
