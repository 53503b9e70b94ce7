// The float64 fused compact-WY right-apply with Gram and projection, on
// Hopper's float64 tensor cores.
//
// Computes what csrc/wy_gram.cu computes (same four variants <GRAM, SCALE,
// OUT>, same C interface, same walk and partial sums), for float64:
//
//   X   = J V,   JQ1 = (J - X W) * s,   G = JQ1^T JQ1,   p = JQ1^T rx.
//
// wy_gram.cu's template runs its products on the FMA pipes with 8 x 8
// register tiles; at float64 that accumulator took every register and
// spilled, and the FMA pipes give half the card's float64 rate.  Here every
// product of a tile is a float64 tensor-core mma.sync (wgmma has no float64
// form): m16n8k8 steps for X and the apply (m16n8k4 for a last four of the
// depth), m16n8k16 for the Gram.  It rounds each product and sum as IEEE
// double: the accuracy class of the float64 chain of matrix products.
//
// Bound.  At the main shape (5,000,000 x 100, k = 50) the function moves
// 4 GB in and 4 GB out (JQ1) and does 4 m n k + m n (n + 1) operations:
// by bytes 2.4 ms, by operations at the 67 TF float64 tensor-core rate
// 2.3 ms (the Gram variants) or 1.5 ms (the apply).  With 8-byte operands
// and no ldmatrix for them, the shared-memory pipe (128 bytes a cycle) has
// to feed the tensor cores: an m16n8k8 takes 1.5 KB of fragments, which is
// more than the pipe delivers in the cycles the mma takes.  So each warp
// keeps one A fragment in registers across up to four B fragments (16 x 32
// output tiles), and in the Gram the A fragment of a row of blocks serves
// every block of that row the warp owns.  Measured (chip_wy64_variants.py,
// which builds this file with the constants below changed): the tensor
// cores reach 65 TF from registers, this kernel about half of that; 32-row
// warp tiles (half the B loads) did not help, m16n8k16 in the Gram did
// (6 %), 12 warps a block did not; without its mma the kernel still takes
// two thirds of its time at the main shape (the copies and the schedule).
//
// Design.
//   * One block of 256 threads (8 warps) an SM: the layout of the main
//     shape takes 228 KB of shared memory.  Partial G sums of the warp's
//     Gram blocks stay in registers for the whole walk (at most 40 doubles a
//     thread, n = 128), so nothing spills.
//   * The walk, the partial-sum slots, the reduce kernel, the cp.async ring
//     of two tiles (zero-filled past m) and the JQ1 write are wy_gram.cu's.
//     A shape whose panel leaves no room for two 64-row tiles takes two
//     32-row tiles, then one 16-row tile (every shape the dispatch gate
//     admits has one of the three; ops/wy_hopper.py holds that).
//   * Shared-memory rows of the tiles and of W have a stride of 4 mod 8
//     doubles, and X and V of 4 mod 8 as well: a fragment load (row g,
//     column t of an 8 x 4 lane grid, 8 bytes a lane) then falls on 32
//     distinct banks in each half-warp.
//   * X = tile V: 16 x 32 warp tiles (up to 4 n-blocks of 8, the blocks
//     split evenly over the groups), depth n in steps of 8 and a last step
//     of 4 where n % 8 is 1..4 (columns n .. pad4(n) of the tiles and rows
//     of V are zeros).  X is stored row-major; its columns k .. pad8(k)
//     stay zero.
//   * JQ1 = tile - X W: the accumulator is SEEDED with the J tile and W is
//     staged negated, so D = X (-W) + J gives J - X W in the same mma; then
//     the row scale, and the tile is overwritten in place.  Padding columns
//     are never stored.
//   * G: the upper triangle in 16 x 16 blocks (two m16n8 accumulators
//     each), listed row by row in pairs of rows (b, last - b) so that every
//     pair holds the same count, and cut into 8 runs of consecutive blocks,
//     one a warp.  A warp loads the A fragment of a row once for all its
//     blocks in that row.  The A fragment of row I is the pair of B
//     fragments of columns 2I and 2I + 1 (tile^T against the tile), so all
//     Gram fragments are plain 8-byte loads of the tile.  Entries below the
//     diagonal and past n are summed and never stored; the reduce kernel
//     mirrors the triangle, so G is symmetric to the bit.
//   * p: summed on the FMA pipes as in wy_gram.cu (1 % of the work).
//   * Schedule per tile t, as wy_gram.cu's: apply(t) | out(t), X(t + 1),
//     Gram(t), p(t) | copy of t + 2 into t's slot.

#define WY_GRAM_F64
#include "wy_gram.cu"

namespace {
namespace f64 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Gram blocks (16 x 16) a warp owns at most: n = 128 has 36.
constexpr int kMaxBlocks = (36 + kWarps - 1) / kWarps;
// Depth of the mma steps of X and the apply (m16n8k8) and of the Gram
// (m16n8k16).
constexpr int kStep = 8;
constexpr int kStepGram = 16;
// 16-row blocks a warp item of X and of the apply spans.
constexpr int kRowBlocks = 1;

__host__ __device__ inline int pad8(int x) { return (x + 7) / 8 * 8; }
// Row stride (doubles) of the tiles and of W: n padded to 4, then to 4 mod 8.
__host__ __device__ inline int tile_stride(int n) {
  const int s = pad4(n);
  return s % 8 ? s : s + 4;
}
// Row stride of X and V: k padded to 8, plus 4.
__host__ __device__ inline int x_stride(int k) { return pad8(k) + 4; }

// Shared memory in doubles: `stages` tiles (rb, np), X (rb, kx), -W
// (pad8(k), np), V (pad4(n), kx), and rx and s beside every tile.  The
// tiles come first and X right after them: the Gram's fragment loads of the
// last columns read up to 15 doubles past a tile row, inside the buffer.
__host__ __device__ inline size_t shared_elems(int n, int k, int rb,
                                               int stages) {
  const size_t np = tile_stride(n), kx = x_stride(k);
  return (size_t)stages * rb * np + (size_t)rb * kx + (size_t)pad8(k) * np +
         (size_t)pad4(n) * kx + (size_t)2 * stages * rb;
}

// D += A B on the float64 tensor cores, A (16 x K), B (K x 8), K = 4, 8
// or 16.  Fragments (g = lane / 4, t = lane % 4): A a[v] at (g + 8 (v % 2),
// t + 4 (v / 2)), B b[q] at (t + 4 q, g), C (16 x 8) c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
template <int K>
__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[K / 2],
                                    const double (&b)[K / 4]);
template <>
__device__ __forceinline__ void mma<4>(double (&d)[4], const double (&a)[2],
                                       const double (&b)[1]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <>
__device__ __forceinline__ void mma<8>(double (&d)[4], const double (&a)[4],
                                       const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <>
__device__ __forceinline__ void mma<16>(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// A fragment from shared memory: p at the lane's (g, t) element, m8 / k4
// the offsets of 8 rows / 4 columns of A.
template <int K>
__device__ __forceinline__ void load_a(double (&a)[K / 2], const double* p,
                                       int m8, int k4) {
#pragma unroll
  for (int v = 0; v < K / 2; ++v) a[v] = p[(v & 1) * m8 + (v >> 1) * k4];
}
// B fragment: p at the lane's (t, g) element, k4 the offset of 4 rows.
template <int K>
__device__ __forceinline__ void load_b(double (&b)[K / 4], const double* p,
                                       int k4) {
#pragma unroll
  for (int q = 0; q < K / 4; ++q) b[q] = p[q * k4];
}

// acc[i][j] += A_i B_j for i < MI, j < jn over the depth [d, end) in steps
// of K, where A_i = rows 16 i .. of a matrix whose rows are `lda` apart and
// B_j = the 8 columns 8 j of a row-major matrix whose rows are `ldb` apart
// (a, b at the lane's elements of depth 0).  Returns the depth reached.
template <int K, int MI>
__device__ __forceinline__ int mma_run(double (&acc)[MI][4][4], const double* a,
                                       int lda, const double* b, int ldb,
                                       int jn, int d, int end) {
#pragma unroll 2
  for (; d + K <= end; d += K) {
    double af[MI][K / 2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      load_a<K>(af[i], a + (size_t)16 * i * lda + d, 8 * lda, 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < jn) {
        double bf[K / 4];
        load_b<K>(bf, b + (size_t)d * ldb + 8 * j, 4 * ldb);
#pragma unroll
        for (int i = 0; i < MI; ++i) mma<K>(acc[i][j], af[i], bf);
      }
  }
  return d;
}

// Position e of the Gram block list: rows of 16 x 16 blocks taken in pairs
// (b, nb - 1 - b), each row from its diagonal block to the last column.
__device__ __forceinline__ void gram_block(int e, int nb, int& I, int& JJ) {
  I = -1;
  JJ = 0;
  for (int b = 0; 2 * b < nb; ++b)
    for (int h = 0; h < 2; ++h) {
      const int row = h ? nb - 1 - b : b;
      if (h && row == b) break;
      const int len = nb - row;
      if (I < 0 && e < len) {
        I = row;
        JJ = row + e;
      }
      e -= len;
    }
}

template <bool GRAM, bool SCALE, bool OUT, int RB, int NS>
__global__ void __launch_bounds__(kThreads, 1)
wy_gram_f64_kernel(const double* __restrict__ J, const double* __restrict__ V,
                   const double* __restrict__ W, const double* __restrict__ rx,
                   const double* __restrict__ s, double* __restrict__ out,
                   double* __restrict__ ws, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = tile_stride(n), kx = x_stride(k), k8 = pad8(k), n4 = pad4(n);
  double* tiles = reinterpret_cast<double*>(smem_raw);  // NS x (RB, np)
  double* Xs = tiles + (size_t)NS * RB * np;            // (RB, kx)
  double* Wn = Xs + (size_t)RB * kx;                    // (k8, np): -W
  double* Vs = Wn + (size_t)k8 * np;                    // (n4, kx)
  double* rxs = Vs + (size_t)n4 * kx;                   // NS x (RB,)
  double* ss = rxs + NS * RB;                           // NS x (RB,)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int P = gridDim.x;
  const int nunits = (m + kUnit - 1) / kUnit;
  constexpr int H = kUnit / RB;                   // tiles a unit
  constexpr int MB = RB / 16;                     // 16-row blocks a tile
  const int xb = k8 / 8;                          // 8-column blocks of X
  const int nb8 = (n + 7) / 8;                    // 8-column blocks of JQ1
  const bool vec = (n % 2) == 0;                  // rows of whole 16 bytes
  const int cpr = n / 2;

  // The ring and X start as zeros (their padding columns stay zeros: the
  // copies and the stores below never touch them); -W and V zero-padded.
  for (int i = tid; i < NS * RB * np + RB * kx; i += kThreads) tiles[i] = 0.0;
  for (int i = tid; i < k8 * np; i += kThreads) {
    const int r = i / np, c = i - r * np;
    Wn[i] = r < k && c < n ? -W[r * n + c] : 0.0;
  }
  for (int i = tid; i < n4 * kx; i += kThreads) {
    const int r = i / kx, c = i - r * kx;
    Vs[i] = r < n && c < k ? V[r * k + c] : 0.0;
  }
  __syncthreads();          // the zeros land before any copy into the ring

  // Gram ownership: blocks [lo, lo + cnt) of the list, (I, JJ) each; the
  // second m16n8 half of a block exists where column 16 JJ + 8 < n.
  const int nbg = (n + 15) / 16;
  const int nblocks = nbg * (nbg + 1) / 2;
  const int lo = warp * nblocks / kWarps;
  const int cnt = (warp + 1) * nblocks / kWarps - lo;
  int gI[kMaxBlocks], gJ[kMaxBlocks];
  double gacc[kMaxBlocks][2][4];
#pragma unroll
  for (int b = 0; b < kMaxBlocks; ++b) {
    gram_block(lo + b, nbg, gI[b], gJ[b]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) gacc[b][h][q] = 0.0;
  }
  double pacc = 0.0;

  auto has = [&](int seq) { return blockIdx.x + P * (seq / H) < nunits; };
  auto row0 = [&](int seq) {
    return (long long)(blockIdx.x + P * (seq / H)) * kUnit + (seq % H) * RB;
  };
  auto copy_in = [&](int seq, int buf) {
    const long long r0 = row0(seq);
    double* tile = tiles + (size_t)buf * RB * np;
    if (vec) {
      for (int q = tid; q < RB * cpr; q += kThreads) {
        const int r = q / cpr, ch = q - r * cpr;
        const bool live = r0 + r < m;
        const double* src = live ? J + (size_t)(r0 + r) * n + 2 * ch : J;
        cp_async16(tile + r * np + 2 * ch, src, live ? 16 : 0);
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

  // ---- X = tile V: warp items (MI 16-row blocks, up to 4 column blocks) --
  constexpr int MI = kRowBlocks < MB ? kRowBlocks : MB;
  auto stage_x = [&](const double* tile) {
    const int ngr = (xb + 3) / 4;
    for (int item = warp; item < MB / MI * ngr; item += kWarps) {
      const int mb = item % (MB / MI) * MI, gr = item / (MB / MI);
      const int c0 = gr * xb / ngr, jn = (gr + 1) * xb / ngr - c0;
      double acc[MI][4][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;
      const double* ar = tile + (16 * mb + g) * np + t;
      const double* br = Vs + t * kx + 8 * c0 + g;
      int d = mma_run<kStep, MI>(acc, ar, np, br, kx, jn, 0, n4);
      if (kStep > 8) d = mma_run<8, MI>(acc, ar, np, br, kx, jn, d, n4);
      mma_run<4, MI>(acc, ar, np, br, kx, jn, d, n4);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * (c0 + j) + 2 * t;
          double* x0 = Xs + (16 * (mb + i) + g) * kx + c;
          if (j < jn && c < k) {
            x0[0] = acc[i][j][0];
            x0[8 * kx] = acc[i][j][2];
            if (c + 1 < k) {
              x0[1] = acc[i][j][1];
              x0[8 * kx + 1] = acc[i][j][3];
            }
          }
        }
    }
  };

  // ---- JQ1 tile = (tile + X (-W)) * s in place: items as in stage_x -------
  auto stage_apply = [&](double* tile, int buf) {
    const int ngr = (nb8 + 3) / 4;
    for (int item = warp; item < MB / MI * ngr; item += kWarps) {
      const int mb = item % (MB / MI) * MI, gr = item / (MB / MI);
      const int c0 = gr * nb8 / ngr, jn = (gr + 1) * nb8 / ngr - c0;
      double acc[MI][4][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const double* t0 = tile + (16 * (mb + i) + g) * np;
        const double* t1 = t0 + 8 * np;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * (c0 + j) + 2 * t;
          acc[i][j][0] = c < n ? t0[c] : 0.0;
          acc[i][j][1] = c + 1 < n ? t0[c + 1] : 0.0;
          acc[i][j][2] = c < n ? t1[c] : 0.0;
          acc[i][j][3] = c + 1 < n ? t1[c + 1] : 0.0;
        }
      }
      const double* ar = Xs + (16 * mb + g) * kx + t;
      const double* br = Wn + t * np + 8 * c0 + g;
      const int q = mma_run<kStep, MI>(acc, ar, kx, br, np, jn, 0, k8);
      if (kStep > 8) mma_run<8, MI>(acc, ar, kx, br, np, jn, q, k8);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = 16 * (mb + i) + g;
        double* t0 = tile + r * np;
        double* t1 = t0 + 8 * np;
        const double s0 = SCALE ? ss[buf * RB + r] : 1.0;
        const double s1 = SCALE ? ss[buf * RB + r + 8] : 1.0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * (c0 + j) + 2 * t;
          if (j >= jn) continue;
          if (c < n) {
            t0[c] = SCALE ? acc[i][j][0] * s0 : acc[i][j][0];
            t1[c] = SCALE ? acc[i][j][2] * s1 : acc[i][j][2];
          }
          if (c + 1 < n) {
            t0[c + 1] = SCALE ? acc[i][j][1] * s0 : acc[i][j][1];
            t1[c + 1] = SCALE ? acc[i][j][3] * s1 : acc[i][j][3];
          }
        }
      }
    }
  };

  // ---- JQ1 out to device memory from the finished tile --------------------
  auto stage_out = [&](const double* tile, long long r0) {
    if (vec) {
      for (int q = tid; q < RB * cpr; q += kThreads) {
        const int r = q / cpr, ch = q - r * cpr;
        if (r0 + r < m)
          *reinterpret_cast<double2*>(out + (size_t)(r0 + r) * n + 2 * ch) =
              *reinterpret_cast<const double2*>(tile + r * np + 2 * ch);
      }
    } else {
      for (int q = tid; q < RB * n; q += kThreads) {
        const int r = q / n, c = q - r * n;
        if (r0 + r < m) out[(size_t)(r0 + r) * n + c] = tile[r * np + c];
      }
    }
  };

  // ---- G += tile^T tile on the warp's blocks, p += tile^T rx --------------
  auto stage_gram = [&](const double* tile, int buf) {
    constexpr int KG = kStepGram < RB ? kStepGram : RB;
#pragma unroll 2
    for (int r8 = 0; r8 < RB; r8 += KG) {
      const double* base = tile + (r8 + t) * np + g;   // (row r8 + t, column g)
      double a[KG / 2];
#pragma unroll
      for (int b = 0; b < kMaxBlocks; ++b)
        if (b < cnt) {
          if (b == 0 || gI[b] != gI[b - 1])
            load_a<KG>(a, base + 16 * gI[b], 8, 4 * np);
          const int cj = 16 * gJ[b];
          double bl[KG / 4];
          load_b<KG>(bl, base + cj, 4 * np);
          mma<KG>(gacc[b][0], a, bl);
          if (cj + 8 < n) {
            load_b<KG>(bl, base + cj + 8, 4 * np);
            mma<KG>(gacc[b][1], a, bl);
          }
        }
    }
    // p: column tid % 128, rows part, part + parts, ... of the tile
    constexpr int kParts = kThreads / 128;
    if ((tid & 127) < n) {
      const double* rxt = rxs + buf * RB;
      const double* col = tile + (tid & 127);
#pragma unroll 4
      for (int r = tid >> 7; r < RB; r += kParts) pacc += rxt[r] * col[r * np];
    }
  };

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
    double* tile = tiles + (size_t)buf * RB * np;
    stage_apply(tile, buf);
    if (NS == 2) cp_async_wait<0>();        // tile seq + 1 has landed
    __syncthreads();
    if (OUT) stage_out(tile, row0(seq));
    if (NS == 2 && has(seq + 1)) stage_x(tiles + (size_t)(buf ^ 1) * RB * np);
    if (GRAM) stage_gram(tile, buf);
    __syncthreads();                        // slot `buf` and X are free
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
    double* slot = ws + (size_t)blockIdx.x * ((size_t)n * n + n);
#pragma unroll
    for (int b = 0; b < kMaxBlocks; ++b)
      if (b < cnt) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 16 * gI[b] + g + 8 * (q >> 1);
            const int j = 16 * gJ[b] + 8 * h + 2 * t + (q & 1);
            if (i <= j && j < n) slot[(size_t)i * n + j] = gacc[b][h][q];
          }
      }
    // the parts of p, added in index order (the ring is idle by now)
    constexpr int kParts = kThreads / 128;
    double* parts = tiles;
    __syncthreads();
    if ((tid & 127) < n) parts[(tid >> 7) * n + (tid & 127)] = pacc;
    __syncthreads();
    if (tid < n) {
      double sum = 0.0;
      for (int h = 0; h < kParts; ++h) sum += parts[h * n + tid];
      slot[(size_t)n * n + tid] = sum;
    }
  }
}

template <bool GRAM, bool SCALE, bool OUT, int RB, int NS>
int launch_tiled(const double* J, const double* V, const double* W,
                 const double* rx, const double* s, double* out, double* ws,
                 double* gp, int m, int n, int k, int nparts,
                 cudaStream_t stream) {
  const size_t smem = shared_elems(n, k, RB, NS) * sizeof(double);
  auto kernel = wy_gram_f64_kernel<GRAM, SCALE, OUT, RB, NS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nparts, kThreads, smem, stream>>>(J, V, W, rx, s, out, ws, m, n, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (GRAM) {
    const int elems = n * n + n;
    wy_reduce_kernel<double><<<(elems + 255) / 256, 256, 0, stream>>>(
        ws, gp, nparts, n);
    err = cudaGetLastError();
  }
  return (int)err;
}

// Two 64-row tiles, else two 32-row tiles, else one 16-row tile: the first
// that fits the card's limit (a function of (n, k) and the limit only).
template <bool GRAM, bool SCALE, bool OUT>
int launch(const double* J, const double* V, const double* W, const double* rx,
           const double* s, double* out, double* ws, double* gp, int m, int n,
           int k, int nparts, size_t limit, cudaStream_t stream) {
  if (shared_elems(n, k, 64, 2) * sizeof(double) <= limit)
    return launch_tiled<GRAM, SCALE, OUT, 64, 2>(J, V, W, rx, s, out, ws, gp,
                                                 m, n, k, nparts, stream);
  if (shared_elems(n, k, 32, 2) * sizeof(double) <= limit)
    return launch_tiled<GRAM, SCALE, OUT, 32, 2>(J, V, W, rx, s, out, ws, gp,
                                                 m, n, k, nparts, stream);
  if (shared_elems(n, k, 16, 1) * sizeof(double) <= limit)
    return launch_tiled<GRAM, SCALE, OUT, 16, 1>(J, V, W, rx, s, out, ws, gp,
                                                 m, n, k, nparts, stream);
  return (int)cudaErrorInvalidValue;
}

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
  const double* j = (const double*)J;
  const double* v = (const double*)V;
  const double* w = (const double*)W;
  const double* r = (const double*)rx;
  const double* sc = (const double*)s;
  double* o = (double*)out;
  double* wsp = (double*)ws;
  double* gpp = (double*)gp;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      return launch<false, false, true>(j, v, w, r, sc, o, wsp, gpp, m, n, k,
                                        nparts, smem, st);
    case 1:
      return launch<true, false, true>(j, v, w, r, sc, o, wsp, gpp, m, n, k,
                                       nparts, smem, st);
    case 2:
      return launch<true, true, true>(j, v, w, r, sc, o, wsp, gpp, m, n, k,
                                      nparts, smem, st);
    case 3:
      return launch<true, true, false>(j, v, w, r, sc, o, wsp, gpp, m, n, k,
                                       nparts, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace f64
}  // namespace

// C interface: as wy_gram_f32 (csrc/wy_gram.cu), for float64 operands.
extern "C" int wy_gram_f64(const void* J, const void* V, const void* W,
                           const void* rx, const void* s, void* out, void* ws,
                           void* gp, int m, int n, int k, int variant,
                           int nparts, void* stream) {
  return f64::run(J, V, W, rx, s, out, ws, gp, m, n, k, variant, nparts,
                  stream);
}

// Shared memory (bytes) of the float64 tiling with `rb`-row tiles in a ring
// of `stages`, as the kernel above lays it out (itemsize is 8).
extern "C" long long wy_gram_shared_bytes(int n, int k, int itemsize, int rb,
                                          int stages) {
  return (long long)(f64::shared_elems(n, k, rb, stages) * itemsize);
}
