// ga_step.cu — fused GA generations on Hopper (sm_90a): K1, and the island
// ring's epoch kernels K2 and K3, one thread block per island.
//
// Replaces three Pallas TPU kernels of the JAX package
// (src/repro/kernels/ga_step.py):
//
//   K1 ga_generation      <- ga_generation_kernel: `gens` generations of
//                            every island (replica) of a stack;
//   K2 ga_epoch           <- ga_epoch_kernel: `intervals` migration
//                            intervals of `migrate_every` generations, with
//                            the ring migration between intervals inside the
//                            kernel (or none: the resident-free mode; or
//                            the intra-shard part only: `boundary`); unlike
//                            the TPU kernel it returns the best of each
//                            interval, not their fold over the launch;
//   K3 ga_streamed_epoch  <- ga_streamed_epoch_kernel: one interval of each
//                            island of a tile, returning the pre-splice
//                            elites and worst slots for a splice outside.
//
// One generation (`generation` below) is the paper's datapath: a clock of
// the three LFSR banks (selection, crossover, mutation) by `steps` bits, the
// FFM stage (decode + the problem's float32 expression), 2-way tournaments
// on the top `idx_bits` of the selection draws, mask-shift single-point
// crossover with per-variable cut points, and an XOR mutation of the first
// P rows; with `track_best` it folds the running best individual with
// strict improvement and the first-occurrence tie rule of the reference
// scan.  K1, K2 and K3 all run that one device function, so every plan of
// the island ring evolves the same populations bit for bit.
//
// What bounds them.  At the full-width shape (N=1024, V=8, 128 islands, 64
// generations a launch) an island's state is N*V + 2N + V*N/2 + V*N =
// 22,528 words (88 KiB), 11 MiB for the stack, so HBM traffic is 2 x 11 MiB
// = 23.6 MB per launch: 7 us at 3.35 TB/s.  The work is integer and float32
// issue: every generation advances the 14,336 words of the three LFSR banks
// by 3 clocks, evaluates N fitness values, and runs N tournaments and N*V/2
// crossovers: ~0.35 M operations per island and generation counting the
// LFSR advance as a GF(2) leap of 5 word ops a clock, 2.84 G a launch, 42 us
// at the card's 67 T/s non-tensor float32 rate (the count chip_smoke.py
// makes).  So all three kernels are operation-bound.  The migration adds one
// FFM pass and two block reductions per interval (~2% of an interval of 16
// generations); K3 adds one state read and write per interval instead of
// per launch.  The banks are clocked one bit at a time (9 ops a clock), the
// simple form; the leap is a later optimisation.
//
// What the design does about it.  An island's whole GA state (population,
// offspring, fitness, the three LFSR banks) lives in dynamic shared memory
// for all of a launch's generations: HBM sees one state read and one write
// per launch (per interval in K3), and every tournament gather is one
// shared-memory read (the TPU kernels' one-hot MXU lane has no purpose
// here).  The block holds 4 * (N * (3.5 V + 3) + 3 V + 66) bytes (K2/K3:
// V + 1 words more), which must fit the 227 KB a block can use; the Python
// wrappers check this before launching.
//
// K2's ring.  The TPU kernel keeps every island of a replica group in one
// VMEM block; a Hopper block is far smaller, so K2 gives each island its own
// block and makes the I islands of a group one thread-block cluster
// (I <= 8, the portable cluster size).  At the end of an interval each block
// evaluates the migration fitness, finds its first-occurrence best and
// worst slots, and copies its elite row into a V-word buffer; after a
// cluster barrier it reads the buffer of island (rank - 1) mod I through
// distributed shared memory (DSMEM), and after a second barrier — so no
// block overwrites or leaves before its neighbour has read — splices it into
// its worst slot.  The exchange never touches HBM.
//
// K3's tile.  On the TPU the streamed tile exists to double-buffer HBM
// copies; on Hopper the blocks of a launch already run in parallel on 132
// SMs, so a block walks its `tile` islands in turn through the same shared
// memory (load, interval, write back), and the planner's tile is 1.
//
// Numerics.  Built with -fmad=false and the default IEEE division and
// square root, so each float operation rounds once, in the order the plain
// PyTorch version (repro_torch/core/fitness.py) evaluates it: cubes as
// x*(x*x), sums over V left to right.  Integer work is exact.  A slot of the
// migration rule is the first occurrence of the block's best (worst) value,
// or N — no slot — when any fitness of the island is NaN, the masked-iota
// rule of repro_torch/core/islands.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;   // 227 KB of dynamic shared memory a block
constexpr int kMaxCluster = 8;       // portable thread-block cluster size

enum Problem { kF1 = 0, kF2, kF3, kSphere, kRastrigin, kRosenbrock, kAckley };

// The GA's shape and operator constants.
struct Shape {
  int n, v, c, idx_bits, cut_bits, p, steps, minimize, problem;
};

// A stack of islands in global memory; island k's rows start at k times the
// per-island size of each array.
struct Stack {
  const uint32_t* x_in;      // [K, N, V]
  const uint32_t* sel_in;    // [K, 2, N]
  const uint32_t* cross_in;  // [K, V, N/2]
  const uint32_t* mut_in;    // [K, V, N]
  uint32_t* x_out;
  uint32_t* sel_out;
  uint32_t* cross_out;
  uint32_t* mut_out;
  float* y_out;              // [K, N]
  float* best_y;             // [K]      (track_best)
  uint32_t* best_x;          // [K, V]   (track_best)
  const float* lo;           // [V] decode offsets
  const float* span;         // [V] decode steps
};

// One island's state in dynamic shared memory.
struct Island {
  uint32_t* x;       // [N, V]
  uint32_t* w;       // [N, V] tournament winners (scratch between phases)
  float* y;          // [N]
  uint32_t* sel;     // [2, N]
  uint32_t* cross;   // [V, N/2]
  uint32_t* mut;     // [V, N]
  float* lo;         // [V]
  float* span;       // [V]
  uint32_t* bx;      // [V] running best individual
  float* by;         // [1] (+1 spare)
  float* rval;       // [32] block-reduction scratch
  int* ridx;         // [32]
  uint32_t* elite;   // [V] epoch kernels: the elite a neighbour reads
  int* slot;         // [1] epoch kernels: a slot broadcast to the block
};

__host__ __device__ inline size_t smem_words(int n, int v) {
  return 2 * (size_t)n * v          // population + offspring
         + n                        // fitness
         + 2 * (size_t)n            // selection bank
         + (size_t)v * (n / 2)      // crossover bank
         + (size_t)v * n            // mutation bank
         + 3 * (size_t)v + 2        // lo, span, best x, best y, spare
         + 64;                      // block-reduction scratch
}

__host__ __device__ inline size_t epoch_smem_words(int n, int v) {
  return smem_words(n, v) + v + 1;  // + elite row, slot
}

__host__ inline int threads_for(int n) {
  return n < 32 ? 32 : (n > kMaxThreads ? kMaxThreads : n);
}

__device__ Island carve(uint32_t* smem, int n, int v) {
  Island s;
  s.x = smem;
  s.w = s.x + (size_t)n * v;
  s.y = (float*)(s.w + (size_t)n * v);
  s.sel = (uint32_t*)(s.y + n);
  s.cross = s.sel + 2 * n;
  s.mut = s.cross + (size_t)v * (n / 2);
  s.lo = (float*)(s.mut + (size_t)v * n);
  s.span = s.lo + v;
  s.bx = (uint32_t*)(s.span + v);
  s.by = (float*)(s.bx + v);
  s.rval = s.by + 2;
  s.ridx = (int*)(s.rval + 32);
  s.elite = (uint32_t*)(s.ridx + 32);
  s.slot = (int*)(s.elite + v);
  return s;
}

__device__ __forceinline__ uint32_t lfsr_clock(uint32_t s, int steps) {
  // r^32 + r^22 + r^2 + 1: feedback s31 ^ s21 ^ s1 ^ s0 into bit 0
  for (int t = 0; t < steps; ++t) {
    uint32_t fb = ((s >> 31) ^ (s >> 21) ^ (s >> 1) ^ s) & 1u;
    s = (s << 1) | fb;
  }
  return s;
}

struct Decoder {
  const uint32_t* xi;
  uint32_t mask;
  const float* lo;
  const float* span;
  __device__ __forceinline__ float operator()(int j) const {
    return lo[j] + (float)(xi[j] & mask) * span[j];
  }
};

__device__ float ffm(int problem, const Decoder& d, int v) {
  switch (problem) {
    case kF1: {
      float x = d(1);
      return x * (x * x) - 15.0f * (x * x) + 500.0f;
    }
    case kF2:
      return 8.0f * d(0) + (-4.0f * d(1) + 1020.0f);
    case kF3: {
      float a = d(0), b = d(1);
      return sqrtf(fmaxf(a * a + b * b, 0.0f));
    }
    case kSphere: {
      float a = d(0);
      float acc = a * a;
      for (int j = 1; j < v; ++j) {
        float b = d(j);
        acc = acc + b * b;
      }
      return acc;
    }
    case kRastrigin: {
      float acc = 0.0f;
      for (int j = 0; j < v; ++j) {
        float a = d(j);
        float t = a * a - 10.0f * cosf(6.283185307179586f * a) + 10.0f;
        acc = j ? acc + t : t;
      }
      return acc;
    }
    case kRosenbrock: {
      float acc = 0.0f;
      float a = d(0);
      for (int j = 0; j + 1 < v; ++j) {
        float b = d(j + 1);
        float dd = b - a * a;
        float e = 1.0f - a;
        float t = 100.0f * (dd * dd) + e * e;
        acc = j ? acc + t : t;
        a = b;
      }
      return acc;
    }
    case kAckley: {
      float s1 = 0.0f, s2 = 0.0f;
      for (int j = 0; j < v; ++j) {
        float a = d(j);
        float q = a * a;
        float cs = cosf(6.283185307179586f * a);
        s1 = j ? s1 + q : q;
        s2 = j ? s2 + cs : cs;
      }
      float fv = (float)v;
      float m1 = s1 / fv, m2 = s2 / fv;
      return -20.0f * expf(-0.2f * sqrtf(m1)) - expf(m2) + 20.0f +
             2.718281828459045f;
    }
  }
  return __int_as_float(0x7fc00000);   // unknown id: NaN (the wrapper rejects it)
}

// `o` replaces `b` when strictly better, or equal at a smaller index: the
// first-occurrence argmin/argmax.  A NaN never wins.
__device__ __forceinline__ bool takes(float ov, int oi, float bv, int bi,
                                      bool minimize) {
  if (minimize ? ov < bv : ov > bv) return true;
  return ov == bv && oi < bi;
}

__device__ __forceinline__ void warp_best(float& bv, int& bi, bool minimize) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, bv, off);
    int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (takes(ov, oi, bv, bi, minimize)) {
      bv = ov;
      bi = oi;
    }
  }
}

// Index of the best fitness in sy[0..n) (first occurrence), valid in thread
// 0.  Every thread of the block must call it.
__device__ int block_best(const float* sy, int n, bool minimize, float* rval,
                          int* ridx) {
  const float sentinel = minimize ? INFINITY : -INFINITY;
  float bv = sentinel;
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float yi = sy[i];
    if (takes(yi, i, bv, bi, minimize)) {
      bv = yi;
      bi = i;
    }
  }
  warp_best(bv, bi, minimize);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    rval[warp] = bv;
    ridx[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    bv = lane < nwarps ? rval[lane] : sentinel;
    bi = lane < nwarps ? ridx[lane] : 0x7fffffff;
    warp_best(bv, bi, minimize);
  }
  return bi;
}

// The migration rule's slot of sy[0..n), returned to every thread: the
// first occurrence of the best value (worst with the sense flipped), or n
// when any value is NaN.  Every thread of the block must call it.
__device__ int block_slot(const Island& s, int n, bool minimize) {
  bool nan = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) nan |= isnan(s.y[i]);
  int b = block_best(s.y, n, minimize, s.rval, s.ridx);
  int any_nan = __syncthreads_or(nan);
  if (threadIdx.x == 0) *s.slot = any_nan ? n : b;
  __syncthreads();
  return *s.slot;
}

// Copy island `k` of the stack into shared memory and reset the best fold.
__device__ void load_island(const Island& s, const Stack& g, const Shape& S,
                            size_t k) {
  const int n = S.n, v = S.v, half = n / 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t ox = k * n * v, osel = k * 2 * n, ocross = k * v * half,
               omut = k * v * n;
  for (int i = tid; i < n * v; i += nt) s.x[i] = g.x_in[ox + i];
  for (int i = tid; i < 2 * n; i += nt) s.sel[i] = g.sel_in[osel + i];
  for (int i = tid; i < v * half; i += nt) s.cross[i] = g.cross_in[ocross + i];
  for (int i = tid; i < v * n; i += nt) s.mut[i] = g.mut_in[omut + i];
  for (int j = tid; j < v; j += nt) {
    s.lo[j] = g.lo[j];
    s.span[j] = g.span[j];
    s.bx[j] = 0u;
  }
  if (tid == 0) *s.by = S.minimize ? INFINITY : -INFINITY;
  __syncthreads();
}

// Write island `k`'s state, fitness and (track_best) best back.
__device__ void store_island(const Island& s, const Stack& g, const Shape& S,
                             size_t k, bool track_best) {
  const int n = S.n, v = S.v, half = n / 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t ox = k * n * v, osel = k * 2 * n, ocross = k * v * half,
               omut = k * v * n;
  for (int i = tid; i < n * v; i += nt) g.x_out[ox + i] = s.x[i];
  for (int i = tid; i < 2 * n; i += nt) g.sel_out[osel + i] = s.sel[i];
  for (int i = tid; i < v * half; i += nt) g.cross_out[ocross + i] = s.cross[i];
  for (int i = tid; i < v * n; i += nt) g.mut_out[omut + i] = s.mut[i];
  for (int i = tid; i < n; i += nt) g.y_out[k * n + i] = s.y[i];
  if (track_best) {
    for (int j = tid; j < v; j += nt) g.best_x[k * v + j] = s.bx[j];
    if (tid == 0) g.best_y[k] = *s.by;
  }
}

// FFM of the island's population into s.y, then a block barrier.
__device__ void eval_ffm(const Island& s, const Shape& S) {
  const uint32_t mask = (1u << S.c) - 1u;
  for (int i = threadIdx.x; i < S.n; i += blockDim.x) {
    Decoder d{s.x + (size_t)i * S.v, mask, s.lo, s.span};
    s.y[i] = ffm(S.problem, d, S.v);
  }
  __syncthreads();
}

// One generation of the island in shared memory.  Every thread of the block
// must call it; it ends on a block barrier.
__device__ void generation(const Island& s, const Shape& S, bool track_best) {
  const int n = S.n, v = S.v, half = n / 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool minimize = S.minimize != 0;
  const uint32_t mask = (1u << S.c) - 1u;
  const int sel_shift = 32 - S.idx_bits, cut_shift = 32 - S.cut_bits,
            mut_shift = 32 - S.c;

  // ---- RNG: clock all three banks --------------------------------------
  for (int i = tid; i < 2 * n; i += nt) s.sel[i] = lfsr_clock(s.sel[i], S.steps);
  for (int i = tid; i < v * half; i += nt)
    s.cross[i] = lfsr_clock(s.cross[i], S.steps);
  for (int i = tid; i < v * n; i += nt) s.mut[i] = lfsr_clock(s.mut[i], S.steps);

  // ---- FFM --------------------------------------------------------------
  eval_ffm(s, S);

  // ---- running best of the pre-update population (thread 0 only) --------
  if (track_best) {
    int b = block_best(s.y, n, minimize, s.rval, s.ridx);
    if (tid == 0) {
      float gb = s.y[b];
      if (minimize ? gb < *s.by : gb > *s.by) {
        *s.by = gb;
        for (int j = 0; j < v; ++j) s.bx[j] = s.x[(size_t)b * v + j];
      }
    }
  }

  // ---- SM: 2-way tournaments, one shared-memory read per contestant -----
  for (int i = tid; i < n; i += nt) {
    int i1 = (int)(s.sel[i] >> sel_shift);
    int i2 = (int)(s.sel[n + i] >> sel_shift);
    float y1 = s.y[i1], y2 = s.y[i2];
    bool first = minimize ? (y1 <= y2) : (y1 >= y2);
    const uint32_t* src = s.x + (size_t)(first ? i1 : i2) * v;
    for (int j = 0; j < v; ++j) s.w[(size_t)i * v + j] = src[j];
  }
  __syncthreads();

  // ---- CM + MM: per pair and variable, crossover then XOR mutation ------
  for (int q = tid; q < half * v; q += nt) {
    int pr = q / v, j = q - pr * v;
    int a = 2 * pr, b = a + 1;
    uint32_t cut = s.cross[(size_t)j * half + pr] >> cut_shift;
    cut = cut < (uint32_t)S.c ? cut : (uint32_t)S.c;
    uint32_t sm = mask >> cut;
    uint32_t w1 = s.w[(size_t)a * v + j], w2 = s.w[(size_t)b * v + j];
    uint32_t z1 = (w1 & ~sm) | (w2 & sm);
    uint32_t z2 = (w2 & ~sm) | (w1 & sm);
    if (a < S.p) z1 ^= s.mut[(size_t)j * n + a] >> mut_shift;
    if (b < S.p) z2 ^= s.mut[(size_t)j * n + b] >> mut_shift;
    s.x[(size_t)a * v + j] = z1;
    s.x[(size_t)b * v + j] = z2;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K1: `gens` generations of each island of the stack, one block an island.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxThreads)
ga_generation(const Stack g, const Shape S, int gens, int track_best) {
  extern __shared__ uint32_t smem[];
  const Island s = carve(smem, S.n, S.v);
  load_island(s, g, S, blockIdx.x);
  for (int t = 0; t < gens; ++t) generation(s, S, track_best != 0);
  store_island(s, g, S, blockIdx.x, track_best != 0);
}

// ---------------------------------------------------------------------------
// K2: resident epochs.  Block (group, island) of a grid of G * I blocks; the
// I blocks of a group form one thread-block cluster when the ring runs.
// ---------------------------------------------------------------------------

struct Epoch {
  int islands, migrate_every, intervals, migrate, boundary;
  uint32_t* send_elite;      // [G, V] boundary: island I-1's elite
  int* worst0;               // [G]    boundary: island 0's worst slot
};

// The ring step of one interval, between the blocks of a cluster through
// distributed shared memory; s.y holds the migration fitness.
__device__ void ring_step(const Island& s, const Shape& S, const Epoch& E) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = S.n, v = S.v, tid = threadIdx.x, nt = blockDim.x;
  const int rank = (int)cluster.block_rank();
  const bool minimize = S.minimize != 0;
  const int b = block_slot(s, n, minimize);
  const int w = block_slot(s, n, !minimize);
  for (int j = tid; j < v; j += nt)
    s.elite[j] = b < n ? s.x[(size_t)b * v + j] : 0u;
  cluster.sync();           // every elite of the cluster is in place
  // island `rank` takes the elite of island rank - 1 (island 0: I - 1)
  const uint32_t* src =
      cluster.map_shared_rank(s.elite, (rank + E.islands - 1) % E.islands);
  for (int j = tid; j < v; j += nt) s.w[j] = src[j];
  cluster.sync();           // no block overwrites or leaves before its
                            // neighbour has read its elite
  if (!(E.boundary && rank == 0) && w < n)
    for (int j = tid; j < v; j += nt) s.x[(size_t)w * v + j] = s.w[j];
  if (E.boundary) {
    const int group = blockIdx.x / E.islands;
    if (rank == E.islands - 1)
      for (int j = tid; j < v; j += nt)
        E.send_elite[(size_t)group * v + j] = s.elite[j];
    if (rank == 0 && tid == 0) E.worst0[group] = w;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
ga_epoch(const Stack g, const Shape S, const Epoch E) {
  extern __shared__ uint32_t smem[];
  const Island s = carve(smem, S.n, S.v);
  const int v = S.v, tid = threadIdx.x, nt = blockDim.x;
  load_island(s, g, S, blockIdx.x);
  for (int it = 0; it < E.intervals; ++it) {
    for (int t = 0; t < E.migrate_every; ++t) generation(s, S, true);
    // the interval's best, then a fresh fold for the next interval (the
    // barrier in eval_ffm orders the reset before the next fold)
    const size_t o = (size_t)it * gridDim.x + blockIdx.x;
    for (int j = tid; j < v; j += nt) {
      g.best_x[o * v + j] = s.bx[j];
      s.bx[j] = 0u;
    }
    if (tid == 0) {
      g.best_y[o] = *s.by;
      *s.by = S.minimize ? INFINITY : -INFINITY;
    }
    eval_ffm(s, S);         // migration fitness of the final populations
    if (E.migrate) ring_step(s, S, E);
  }
  store_island(s, g, S, blockIdx.x, false);   // y: the pre-splice fitness
}

// ---------------------------------------------------------------------------
// K3: one interval of every island, a block walking a tile of islands.
// ---------------------------------------------------------------------------

struct Streamed {
  int islands, tile, migrate_every, migrate;
  uint32_t* elite_x;         // [G, I, V] pre-splice elites
  int* worst_idx;            // [G, I]    pre-splice worst slots
};

__global__ void __launch_bounds__(kMaxThreads)
ga_streamed_epoch(const Stack g, const Shape S, const Streamed T) {
  extern __shared__ uint32_t smem[];
  const Island s = carve(smem, S.n, S.v);
  const int n = S.n, v = S.v, tid = threadIdx.x, nt = blockDim.x;
  const bool minimize = S.minimize != 0;
  const int tiles = T.islands / T.tile;
  const size_t first = (size_t)(blockIdx.x / tiles) * T.islands +
                       (size_t)(blockIdx.x % tiles) * T.tile;
  for (int t = 0; t < T.tile; ++t) {
    const size_t k = first + t;
    load_island(s, g, S, k);
    for (int e = 0; e < T.migrate_every; ++e) generation(s, S, true);
    eval_ffm(s, S);         // migration fitness of the final population
    if (T.migrate) {
      const int b = block_slot(s, n, minimize);
      const int w = block_slot(s, n, !minimize);
      for (int j = tid; j < v; j += nt)
        T.elite_x[k * v + j] = b < n ? s.x[(size_t)b * v + j] : 0u;
      if (tid == 0) T.worst_idx[k] = w;
    }
    store_island(s, g, S, k, true);
    __syncthreads();        // the next island's load overwrites what the
                            // store reads
  }
}

bool bad_shape(size_t smem, int n, int v, int c) {
  return smem > (size_t)kSmemLimit || n < 2 || v < 1 || c < 1 || c > 31;
}

Stack make_stack(const void* x_in, const void* sel_in, const void* cross_in,
                 const void* mut_in, void* x_out, void* sel_out,
                 void* cross_out, void* mut_out, void* y_out, void* best_y,
                 void* best_x, const void* lo, const void* span) {
  return Stack{(const uint32_t*)x_in, (const uint32_t*)sel_in,
               (const uint32_t*)cross_in, (const uint32_t*)mut_in,
               (uint32_t*)x_out, (uint32_t*)sel_out, (uint32_t*)cross_out,
               (uint32_t*)mut_out, (float*)y_out, (float*)best_y,
               (uint32_t*)best_x, (const float*)lo, (const float*)span};
}

// A launch configuration of `blocks` blocks for population size n, with a
// cluster of `cluster` blocks when cluster > 0.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(int blocks, int n, size_t smem, void* stream, int cluster) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads_for(n));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    if (cluster > 0) {
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
    }
  }
};

}  // namespace

extern "C" {

size_t ga_step_smem_bytes(int n, int v) { return 4 * smem_words(n, v); }

size_t ga_epoch_smem_bytes(int n, int v) { return 4 * epoch_smem_words(n, v); }

int ga_step_smem_limit() { return kSmemLimit; }

int ga_step_max_cluster() { return kMaxCluster; }

const char* ga_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1: launch `replicas` blocks on `stream`; returns the cudaError_t of the
// launch (0 = queued).  Pointers are device pointers of contiguous buffers.
int ga_step_launch(const void* x_in, const void* sel_in, const void* cross_in,
                   const void* mut_in, void* x_out, void* sel_out,
                   void* cross_out, void* mut_out, void* y_out, void* best_y,
                   void* best_x, const void* lo, const void* span,
                   int replicas, int n, int v, int c, int idx_bits,
                   int cut_bits, int p, int steps, int minimize, int problem,
                   int gens, int track_best, void* stream) {
  size_t smem = 4 * smem_words(n, v);
  if (bad_shape(smem, n, v, c) || replicas < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ga_generation, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Stack g = make_stack(x_in, sel_in, cross_in, mut_in, x_out, sel_out,
                             cross_out, mut_out, y_out, best_y, best_x, lo,
                             span);
  const Shape S{n, v, c, idx_bits, cut_bits, p, steps, minimize, problem};
  ga_generation<<<replicas, threads_for(n), smem, (cudaStream_t)stream>>>(
      g, S, gens, track_best);
  return (int)cudaGetLastError();
}

// K2: `groups` x `islands` blocks; with `migrate`, each group's islands are
// one cluster.  `boundary` needs `migrate` and one interval.
int ga_epoch_launch(const void* x_in, const void* sel_in,
                    const void* cross_in, const void* mut_in, void* x_out,
                    void* sel_out, void* cross_out, void* mut_out,
                    void* y_out, void* best_y, void* best_x,
                    void* send_elite, void* worst0, const void* lo,
                    const void* span, int groups, int islands, int n, int v,
                    int c, int idx_bits, int cut_bits, int p, int steps,
                    int minimize, int problem, int migrate_every,
                    int intervals, int migrate, int boundary, void* stream) {
  size_t smem = 4 * epoch_smem_words(n, v);
  if (bad_shape(smem, n, v, c) || groups < 1 || islands < 1 ||
      (migrate && islands > kMaxCluster) || migrate_every < 1 ||
      intervals < 1 || (boundary && (!migrate || intervals != 1)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ga_epoch, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Stack g = make_stack(x_in, sel_in, cross_in, mut_in, x_out, sel_out,
                             cross_out, mut_out, y_out, best_y, best_x, lo,
                             span);
  const Shape S{n, v, c, idx_bits, cut_bits, p, steps, minimize, problem};
  const Epoch E{islands, migrate_every, intervals, migrate, boundary,
                (uint32_t*)send_elite, (int*)worst0};
  Launch L(groups * islands, n, smem, stream, migrate ? islands : 0);
  e = cudaLaunchKernelEx(&L.cfg, ga_epoch, g, S, E);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `islands` K2 blocks at (n, v) the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out; returns the cudaError_t.
int ga_epoch_max_active_clusters(int n, int v, int islands, int* out) {
  size_t smem = 4 * epoch_smem_words(n, v);
  cudaError_t e = cudaFuncSetAttribute(
      ga_epoch, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  Launch L(islands, n, smem, nullptr, islands);
  return (int)cudaOccupancyMaxActiveClusters(out, ga_epoch, &L.cfg);
}

// K3: `groups` x `islands / tile` blocks, each walking `tile` islands.
int ga_streamed_launch(const void* x_in, const void* sel_in,
                       const void* cross_in, const void* mut_in, void* x_out,
                       void* sel_out, void* cross_out, void* mut_out,
                       void* y_out, void* best_y, void* best_x,
                       void* elite_x, void* worst_idx, const void* lo,
                       const void* span, int groups, int islands, int tile,
                       int n, int v, int c, int idx_bits, int cut_bits, int p,
                       int steps, int minimize, int problem,
                       int migrate_every, int migrate, void* stream) {
  size_t smem = 4 * epoch_smem_words(n, v);
  if (bad_shape(smem, n, v, c) || groups < 1 || islands < 1 || tile < 1 ||
      islands % tile || migrate_every < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ga_streamed_epoch, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Stack g = make_stack(x_in, sel_in, cross_in, mut_in, x_out, sel_out,
                             cross_out, mut_out, y_out, best_y, best_x, lo,
                             span);
  const Shape S{n, v, c, idx_bits, cut_bits, p, steps, minimize, problem};
  const Streamed T{islands, tile, migrate_every, migrate, (uint32_t*)elite_x,
                   (int*)worst_idx};
  ga_streamed_epoch<<<groups * (islands / tile), threads_for(n), smem,
                      (cudaStream_t)stream>>>(g, S, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
