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
//   K3 ga_streamed_epoch  <- ga_streamed_epoch_kernel: by default one
//                            interval of every island, returning the
//                            pre-splice elites and worst slots for a splice
//                            outside (the TPU kernel's contract); with
//                            `splice`, `intervals` intervals with the ring
//                            inside one cooperative launch (K2's contract,
//                            for island counts past a cluster).
//
// K1 also has a global-memory form, three kernels a generation (ga_ffm,
// ga_best, ga_operators; see the note above them), for the replicas and
// fitness functions the one-block form cannot take.
//
// One generation (`generation` below) is the paper's datapath: 2-way
// tournaments on the top `idx_bits` of the selection draws, mask-shift
// single-point crossover with per-variable cut points, an XOR mutation of
// the first P rows, and the FFM stage (decode + the problem's float32
// expression) of the offspring; each LFSR word is clocked by `steps` just
// before the draw it feeds.  With `track_best` it folds the running best of
// the pre-update population with strict improvement and the
// first-occurrence tie rule of the reference scan.  K1, K2 and K3 all run
// that one device function, so every plan of the island ring evolves the
// same populations bit for bit.
//
// What bounds them.  At the full-width shape (N=1024, V=8, P=21, 128
// islands, 64 generations a launch) an island's HBM state is N*V + 2N +
// V*N/2 + V*N = 22,528 words (88 KiB), so a launch moves 2 x 11 MiB: 7 us
// at 3.35 TB/s.  The work is integer and float32 issue.  A generation of
// an island clocks 2N + V*N/2 + V*P = 6,312 bank words (the mutation rows
// at and past P are never drawn: they are advanced once a launch, about
// 19 instructions a word through a nibble table), runs N tournaments,
// N*V/2 crossovers and N fitness evaluations (N*V cosf for rastrigin).
// chip_smoke.py counts the integer work in instructions (a logic
// expression of up to three operands is one LOP3), two ways: against the
// card's non-tensor float32 rate (0.024 ms a K1 launch), and per op class
// (int32 at 64 a cycle an SM, fp32 at 128, conversions and MUFU at 16, 132
// SMs: 0.057 ms, int32-bound); both say operation-bound.  In practice the
// bound is the
// issue rate of one island's warps: a generation has one barrier, and the
// block's time is that of its slowest warp.  A small island (N=256: 4 warps
// a block of pairs) leaves an SM latency-bound, so there the warps an SM
// holds set the pace: K2's 16-bit layout (below) doubles its blocks, and
// its two-lane form (below) the warps of each.
//
// What the design does about it.
//   * An island's state lives in dynamic shared memory for all of a
//     launch's generations, one block an island: HBM sees one state read
//     and one write a launch (an interval in K3).
//   * Variable-major layout: the population is [V][N] in shared memory
//     (transposed at load and store; HBM keeps [K, N, V]), so the lanes of
//     a warp run along N in every phase and the bank, offspring and decode
//     accesses are free of bank conflicts; only the tournament's parent
//     reads are random.
//   * One thread a pair of individuals (a = 2pr, b = a + 1, at most 512
//     threads): it clocks and draws its own selection, crossover and
//     mutation words, runs the two tournaments, keeps the winners' indices
//     in registers, reads the parents' words, writes the two children into
//     the other of two population buffers and evaluates their fitness into
//     the other of two fitness buffers.  Nothing it writes is read by
//     another thread before the one block barrier of a generation.
//   * K2's two-lane form (kLanes = 2): one thread an individual, a pair's
//     two individuals two adjacent lanes of a warp, so an island of N <=
//     512 is a block of N threads.  Each lane clocks its own two selection
//     words and runs its own tournament; the lanes swap winners with one
//     shuffle and each reads both parents' words and forms its own child.
//     The pair's V cut words are split between the lanes (lane h clocks
//     and writes back the variables j = h mod 2) and swapped with one
//     shuffle a variable pair; only the warps that hold rows below P take
//     the loop with the mutation.  Each lane mutates, stores (one 2-byte
//     store) and evaluates (`ffm<1>`, rastrigin's loop unrolled by two
//     variables) its own child.  Every word is
//     clocked as often and every float operation sees the same operands
//     in the same order as in the pair form, so the state is that form's
//     bit for bit.  The wrapper takes it where the block it makes pays:
//     the 16-bit build without problem data, 32 <= N <= 512, and the card
//     holds as many of its clusters at once as of the pair block's (at
//     the island cell, N=256: 8 warps a block, 32 an SM, not 16; on an
//     H100 a launch of 2 x 16 generations of 51 clusters takes 0.47-0.48
//     ms against the pair form's 0.53).  Every other build keeps one lane
//     a pair.
//   * The word-parallel LFSR advance (`lfsr_advance`): up to 22 clocks in
//     one branch-free pass of 13-17 instructions (shifts and three-input
//     logic), instead of 9 operations a clock.  It was the largest cost of a generation, so the
//     kernels are also built for the paper's 3 clocks a draw as a
//     compile-time constant, which folds every shift and mask; other
//     counts take the run-time form.  The mutation rows at and past P are
//     advanced once at the store, through a table of each nibble's advance
//     (the advance is linear over GF(2)); the block holds only the rows
//     below P, and only where they fit beside the rest (else they are
//     clocked in place in the output bank in global memory, each word by
//     the one thread that owns it, in the run-time form only).
//   * The pair's two fitness evaluations run interleaved (`ffm<2>`) and the
//     crossover loop is unrolled, so independent chains overlap.
//   * The best fold: each warp leaves the best of its individuals in a
//     per-buffer slot before the barrier; after it, the last warp alone
//     (warp 0 has the mutation rows) folds the warp slots and copies the
//     best row with one lane a variable, while the other warps go on.
//   * No pointer array is indexed at run time (`Island::X`, `Y`, `rval`):
//     the island's pointers stay in registers and every access compiles
//     to a shared-memory instruction, with no stack frame.
//   * The block holds 4 * (2NV + 4N + V*N/2 + V*P + 3V + 130) bytes, the
//     V*P term only where it fits (K2/K3: V + 1 words more), 97.3 KiB at
//     the full-width shape, so two island blocks of 512 threads (<= 64
//     registers, __launch_bounds__(512, 2)) share an SM, and K2's 16
//     clusters of 8 fit the card in one wave.  Every shape the layout
//     before this one took still fits.  The Python wrappers check the
//     footprint against the 227 KB a block can use before launching.  The
//     card holds only 15 clusters of 8 with one island an SM, so the 16th
//     shares SMs, which set the launch's pace.
//   * K2's 16-bit layout.  Where the bits a variable c <= 16, every
//     population word the port makes is below 2^16: the initial states keep
//     a word's top c bits (`seed_state`, `init_islands_fast`), crossover
//     takes each bit of a child from one parent, the XOR mutation flips only
//     the low c bits, and a splice copies a row.  On that invariant K2 holds
//     its two population buffers as uint16_t [V][N] (the Python wrapper
//     picks the layout from c alone; HBM keeps int32 words, narrowed at the
//     load and widened at the store; a pair's children are one 4-byte
//     store, a lane's child in the two-lane form one 2-byte store), 4NV
//     bytes less a block: 51,900 B against 82,620 at the island cell
//     (N=256, V=30, P=6), so an SM holds four of its blocks, not two, and
//     its 51 clusters of 8 run in one wave, where the 32-bit layout held
//     30 at once and ran a second wave of 21.  Every operation sees the
//     same values in the same order, so the state is the 32-bit layout's bit
//     for bit.  K1 and K3 keep 32-bit words.
//   * rastrigin_sr (CEC 2017 F5's form) carries data: a shift o [V] and a
//     rotation M [V, V], and an evaluation is a V x V mat-vec.  Its kernels
//     are builds of their own (kData), so the other problems' builds keep
//     their registers and blocks: the data first in the block (M's rows at
//     a stride of V rounded up to 4, then o; 3,968 B at V = 30, a K2 block
//     of 55,868 B at the island cell's shape, four still an SM), and a
//     pair's 2 x 32 shifted values in registers (`ffm_sr`), under
//     __launch_bounds__(512, 1), so up to 128 registers a thread, which at
//     N = 256 still lets four blocks of 128 threads share an SM.  A row of
//     M is one 16-byte broadcast load for the pair's two sums.  V > 32 has
//     no such build: the wrappers route it to K1's global form and the
//     program's PyTorch stage.
//
// K2's ring.  The TPU kernel keeps every island of a replica group in one
// VMEM block; a Hopper block is far smaller, so K2 gives each island its own
// block and makes the I islands of a group one thread-block cluster
// (I <= 8, the portable cluster size).  At the end of an interval the
// fitness buffer already holds the migration fitness (the last
// generation's offspring); each block finds its first-occurrence best and
// worst slots and copies its elite row into a V-word buffer; after a
// cluster barrier it splices the buffer of island (rank - 1) mod I, read
// through distributed shared memory (DSMEM), into its worst slot, and a
// second barrier keeps every block from overwriting or leaving before its
// neighbour has read.  The exchange never touches HBM.  The spliced row's
// fitness is re-evaluated before the next interval.
//
// K3.  On the TPU the streamed tile exists to double-buffer an island stack
// through VMEM.  On Hopper the streamed plan exists only because a cluster
// holds at most 8 islands; one island still fits one block, two blocks an
// SM.  Run as one pass an interval with the splice in PyTorch between
// passes, K3 paid per interval for a state load and store (88 KiB an
// island at the full-width shape), a full evaluation, the nibble advance
// of the rows past P, a launch, nine output allocations and a PyTorch
// splice over the whole stack.  So the `splice` form runs a launch's k
// intervals in one cooperative launch (every block co-resident, or the
// launch is refused; nothing falls back):
//   * the tile T (islands a block walks) is the least divisor of I whose
//     G * I / T blocks the card holds at once (the Python planner, from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs).  At T = 1 an
//     island stays in shared memory for all k intervals: one load, one
//     store, one full evaluation and one nibble advance a launch.  At T > 1
//     a block walks its islands each interval through HBM as a pass did;
//     the pending splice is applied at the next load, and after the last
//     interval in global memory.  When even T = I is too many blocks, the
//     wrapper launches whole groups in waves the card holds;
//   * the ring goes through global memory: at the end of an interval each
//     island writes its elite (V words) into an exchange buffer indexed by
//     the interval's parity, [2, G, I, V], and its worst slot; a barrier
//     spans the I / T blocks of its group (a counter in global memory,
//     release on arrive, acquire on wait), so groups never wait for one
//     another; then each island splices the elite of island (i - 1) mod I
//     into its worst slot and re-evaluates that row as K2 does.  One
//     barrier an interval is enough because of the parity: a block writes
//     buffer it & 1 again only at interval it + 2, after passing barrier
//     it + 1; its neighbour arrives there only after reading buffer it & 1
//     (right after barrier it, or at its next load at T > 1).  Elites are
//     read with ld.global.cg, past the SM's L1.  Without migration there
//     is no barrier and no cooperative launch.
//
// Numerics.  Built with -fmad=false and the default IEEE division and
// square root, so each float operation rounds once, in the order the plain
// PyTorch version (repro_torch/core/fitness.py) evaluates it: cubes as
// x*(x*x), sums over V left to right (rastrigin_sr's mat-vec too).  Integer work is exact.  A slot of the
// migration rule is the first occurrence of the block's best (worst) value,
// or N — no slot — when any fitness of the island is NaN, the masked-iota
// rule of repro_torch/core/islands.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;     // a block's threads: a pair (or, in
                                     // K2's two-lane form, an individual)
                                     // a thread
constexpr int kMinBlocks = 2;        // island blocks an SM can hold at once
constexpr int kSmemLimit = 232448;   // 227 KB of dynamic shared memory a block
constexpr int kMaxCluster = 8;       // portable thread-block cluster size
constexpr int kMaxDevices = 64;
constexpr int kPaperSteps = 3;       // clocks a draw built in as a constant

enum Problem {
  kF1 = 0, kF2, kF3, kSphere, kRastrigin, kRosenbrock, kAckley, kRastriginSR
};

// rastrigin_sr holds an individual's V shifted values in registers: at most
// this many variables (the wrappers route a larger V to the PyTorch stage)
constexpr int kSRMaxVars = 32;

// rastrigin_sr's data in shared memory: M's V rows at a row stride of V
// rounded up to 4 words (16-byte loads), then o, the pad words zero.
__host__ __device__ inline int sr_ld(int v) { return (v + 3) & ~3; }

// Words of problem data a block holds in shared memory (0: none).
__host__ __device__ inline int data_words(int problem, int v) {
  return problem == kRastriginSR ? sr_ld(v) * (v + 1) : 0;
}

// The GA's shape and operator constants; p is min(P, N).  mut_global: the
// mutation rows below P stay in global memory (`Island::gmut`) because
// they do not fit beside the rest of the block.
struct Shape {
  int n, v, c, idx_bits, cut_bits, p, steps, minimize, problem, mut_global;
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
  const float* data;         // the problem's data (o [V], M [V, V]), or null
};

// One island's state in dynamic shared memory.  x and y are double
// buffered: a generation reads buffer `cur` and writes buffer cur ^ 1.
// Buffers are picked with X(b), Y(b), rval(b) rather than pointer arrays: an
// array indexed at run time would put the struct in local memory and hide
// from the compiler that every pointer here addresses shared memory.
// W is the population word: uint32_t, or uint16_t in K2's 16-bit layout
// (see the header), widened at every read and narrowed at every write.
template <class W>
struct Island {
  W* x0;             // [V, N] population, variable-major (buffer 0)
  W* x1;             //        (buffer 1)
  float* y0;         // [N] fitness of x0
  float* y1;         // [N] fitness of x1
  uint32_t* sel;     // [2, N]
  uint32_t* cross;   // [V, N/2]
  uint32_t* mut;     // [V, P] the mutation bank's rows below P
  uint32_t* gmut;    // or, with S.mut_global, nullptr above and these rows
                     // of this island's [V, N] bank in global memory
  float* lo;         // [V]
  float* span;       // [V]
  uint32_t* bx;      // [V] running best individual
  float* by;         // [1] (+1 spare)
  float* red;        // 2 x ([32] values, [32] indices): the per-warp best
                     // of y0 and of y1; a scan after the generations uses
                     // the idle one, the store the whole as its table
  uint32_t* elite;   // [V] epoch kernels: the elite a neighbour reads
  int* slot;         // [1] epoch kernels: a slot broadcast to the block
  float* data;       // rastrigin_sr's builds: its data (`load_sr_data`),
                     // first in the block
  __device__ __forceinline__ W* X(int b) const { return b ? x1 : x0; }
  __device__ __forceinline__ float* Y(int b) const { return b ? y1 : y0; }
  __device__ __forceinline__ float* rval(int b) const { return red + 64 * b; }
  __device__ __forceinline__ int* ridx(int b) const {
    return (int*)(red + 64 * b + 32);
  }
};

// Words of a block of kernel `which` (0: K1; 1, 2: K2, K3) with population
// words of `bits` bits (16: K2's 16-bit layout) and `dw` words of problem
// data, without the mutation rows.
__host__ inline size_t base_words(int which, int n, int v, int bits,
                                  int dw) {
  return (size_t)dw                 // problem data
         + (size_t)n * v * bits / 16  // population, two buffers
         + 2 * (size_t)n            // fitness, two buffers
         + 2 * (size_t)n            // selection bank
         + (size_t)v * (n / 2)      // crossover bank
         + 3 * (size_t)v + 2        // lo, span, best x, best y, spare
         + 2 * 64                   // reductions
         + (which ? v + 1 : 0);     // K2/K3: elite row, slot
}

// Whether the mutation rows below P stay in global memory: they do when
// they would not fit beside the rest.
__host__ inline bool rows_in_global(int which, int n, int v, int p,
                                   int bits, int dw) {
  return 4 * (base_words(which, n, v, bits, dw) + (size_t)v * p) >
         (size_t)kSmemLimit;
}

// Threads of a block at population size n with `lanes` threads a pair: a
// thread a pair (at least a warp, at most kMaxThreads), or in K2's two-lane
// form a thread an individual (the launcher takes it only at 32 <= n <=
// kMaxThreads, n a multiple of 32, so every lane has one).
__host__ inline int threads_for(int n, int lanes) {
  if (lanes == 2) return n;
  const int pairs = n / 2;
  return pairs < 32 ? 32 : (pairs > kMaxThreads ? kMaxThreads : pairs);
}

// The block's layout for island `k` of the stack.  kData (rastrigin_sr's
// builds): the problem's data first, 16-byte aligned, then the rest as in
// the other builds.
template <class W, bool kData>
__device__ __forceinline__ Island<W> carve(uint32_t* smem, const Shape& S,
                                           uint32_t* mut_out, size_t k) {
  // x and sel first (after the data, an even number of words): their pair
  // accesses are vector loads and stores (sel stays 8-byte aligned, as N
  // is even)
  const int n = S.n, v = S.v, p = S.mut_global ? 0 : S.p;
  Island<W> s;
  s.data = (float*)smem;
  s.x0 = (W*)(smem + (kData ? data_words(kRastriginSR, v) : 0));
  s.x1 = s.x0 + (size_t)n * v;
  s.sel = (uint32_t*)(s.x1 + (size_t)n * v);
  s.y0 = (float*)(s.sel + 2 * n);
  s.y1 = s.y0 + n;
  s.cross = (uint32_t*)(s.y1 + n);
  s.mut = s.cross + (size_t)v * (n / 2);
  s.gmut = S.mut_global ? mut_out + k * v * n : nullptr;
  s.lo = (float*)(s.mut + (size_t)v * p);
  s.span = s.lo + v;
  s.bx = (uint32_t*)(s.span + v);
  s.by = (float*)(s.bx + v);
  s.red = s.by + 2;
  s.elite = (uint32_t*)(s.red + 2 * 64);
  s.slot = (int*)(s.elite + v);
  return s;
}

// `t` clocks of r^32 + r^22 + r^2 + 1 (feedback s31 ^ s21 ^ s1 ^ s0 into
// bit 0, the register shifting left), up to 22 at a time.  The feedback of
// clock k is f_k = s[31-k] ^ s[21-k] ^ f_{k-1} ^ f_{k-2}, with f_{-1} = s0
// and f_{-2} = s1: for k < 22 every s term is an original bit, so the k
// new low bits are the tap word (s >> (32-k)) ^ (s >> (22-k)), topped by
// the two initial values, run through the XOR filter 1 / (1 + x + x^2) =
// (1 + x) / (1 + x^3): a stride-3 prefix XOR by doubling, then one more
// shift.  16 int32 operations a chunk of up to 4 clocks, 20 up to 22; up
// to 22 clocks take one branch-free pass, and a `t` known when the kernel
// is compiled folds every shift and mask to a constant.
__device__ __forceinline__ uint32_t lfsr_advance(uint32_t s, int t) {
  if (t <= 0) return s;
  if (t <= 22) {
    const uint32_t m = (1u << t) - 1u, m6 = t > 4 ? ~0u : 0u,
                   m12 = t > 10 ? ~0u : 0u;
    const uint32_t lo = s & 3u;
    uint32_t e = (s >> (32 - t)) ^ ((s >> (22 - t)) & m) ^
                 ((lo ^ (lo >> 1)) << t);
    e ^= e >> 3;
    e ^= (e >> 6) & m6;
    e ^= (e >> 12) & m12;
    return (s << t) | ((e ^ (e >> 1)) & m);
  }
  while (t > 0) {
    const int k = t < 22 ? t : 22;
    const uint32_t m = (1u << k) - 1u;
    const uint32_t lo = s & 3u;
    uint32_t e = (s >> (32 - k)) ^ ((s >> (22 - k)) & m) ^
                 ((lo ^ (lo >> 1)) << k);
    e ^= e >> 3;
    if (k > 4) e ^= e >> 6;
    if (k > 10) e ^= e >> 12;
    s = (s << k) | ((e ^ (e >> 1)) & m);
    t -= k;
  }
  return s;
}

// Clock the LFSR word at `m` (shared or global memory) by `t`; the draw.
__device__ __forceinline__ uint32_t clock_word(uint32_t* m, int t) {
  const uint32_t d = lfsr_advance(*m, t);
  *m = d;
  return d;
}

// Variable j of individual i of a variable-major population.
template <class W>
struct Decoder {
  const W* x;
  int n;
  uint32_t mask;
  const float* lo;
  const float* span;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return lo[j] + (float)(x[(size_t)j * n + i] & mask) * span[j];
  }
};

// Variable j of individual i of a row-major tile in shared memory, row
// stride `stride` (the global form's `ga_ffm`).
struct TileDecoder {
  const uint32_t* x;
  int stride;
  uint32_t mask;
  const float* lo;
  const float* span;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return lo[j] + (float)(x[i * stride + j] & mask) * span[j];
  }
};

// The per-variable terms of the summed problems and ackley's finish, one
// expression each, shared by `ffm` and `ga_ffm`'s spread form: built with
// -fmad=false, a term rounds the same in whichever thread computes it.
__device__ __forceinline__ float sphere_term(float b) { return b * b; }

__device__ __forceinline__ float rastrigin_term(float a) {
  return a * a - 10.0f * cosf(6.283185307179586f * a) + 10.0f;
}

__device__ __forceinline__ float rosenbrock_term(float a, float b) {
  float dd = b - a * a;
  float e = 1.0f - a;
  return 100.0f * (dd * dd) + e * e;
}

__device__ __forceinline__ float ackley_cos(float a) {
  return cosf(6.283185307179586f * a);
}

__device__ __forceinline__ float ackley_of(float s1, float s2, float fv) {
  float m1 = s1 / fv, m2 = s2 / fv;
  return -20.0f * expf(-0.2f * sqrtf(m1)) - expf(m2) + 20.0f +
         2.718281828459045f;
}

// rastrigin_sr (CEC 2017 F5's form) of the K individuals i[0..K) into
// y[0..K), in the plain version's order (repro_torch/core/fitness.py):
// y_j = (x_j - o_j) * 0.0512, z_r = (...(y_0 M_r0 + y_1 M_r1) + ...) +
// y_{V-1} M_r,V-1 from left to right, a product and a sum each rounded,
// then the Rastrigin sum of the z_r and 500.  `data` is shared memory in
// `load_sr_data`'s layout.  An individual's V shifted values live in
// registers, zero past V (kSRMaxVars of them: the wrappers refuse a larger
// V); a row of M is read 4 words at a time, one broadcast load for the K
// individuals, and the pad words past V add 0 * 0 to z, which changes no
// z but the sign of a zero sum, which neither z * z nor cos sees.
template <int K, class D>
__device__ __forceinline__ void ffm_sr(const D& d, const int (&i)[K], int v,
                                       const float* data, float (&y)[K]) {
  const int ld = sr_ld(v);
  const float* o = data + (size_t)v * ld;
  float sv[K][kSRMaxVars];
#pragma unroll
  for (int j = 0; j < kSRMaxVars; ++j) {
    if (j < v) {
      const float oj = o[j];
#pragma unroll
      for (int k = 0; k < K; ++k) sv[k][j] = (d(i[k], j) - oj) * 0.0512f;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) sv[k][j] = 0.0f;
    }
  }
  float s[K];
  for (int r = 0; r < v; ++r) {
    const float4* m = (const float4*)(data + (size_t)r * ld);
    float z[K];
#pragma unroll
    for (int q = 0; q < kSRMaxVars / 4; ++q) {
      if (4 * q >= v) break;
      const float4 w = m[q];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float t = sv[k][4 * q] * w.x;
        z[k] = q ? z[k] + t : t;
        z[k] = z[k] + sv[k][4 * q + 1] * w.y;
        z[k] = z[k] + sv[k][4 * q + 2] * w.z;
        z[k] = z[k] + sv[k][4 * q + 3] * w.w;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float t = rastrigin_term(z[k]);
      s[k] = r ? s[k] + t : t;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) y[k] = s[k] + 500.0f;
}

// rastrigin_sr's data from global memory (o [V], then M's rows [V, V]) into
// `dst` in shared memory: M's rows at stride sr_ld(v), then o, the pad
// words zero.  Every thread of the block calls it; a barrier must follow.
__device__ __forceinline__ void load_sr_data(float* dst, const float* src,
                                             int v) {
  const int ld = sr_ld(v), words = ld * (v + 1);
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const int r = e / ld, j = e - r * ld;
    dst[e] = j >= v ? 0.0f : r < v ? src[v + (size_t)r * v + j] : src[j];
  }
}

// The FFM of the K individuals i[0..K) into y[0..K): each follows the plain
// version's operation order, and the K evaluations run interleaved, step by
// step, so their dependency chains overlap (K = 2: a thread's pair).  `D`
// reads variable j of individual i: `Decoder` in the one-block kernels'
// shared memory, `TileDecoder` in the rows form of `ga_ffm`.  kData:
// rastrigin_sr's builds, whose problem is that one, with its data in
// shared memory; the other builds take the problem at run time.  kUnroll =
// 2 (K2's two-lane form) unrolls rastrigin's loop by two variables: with
// K = 1 a step holds one cosf chain, whose slow-path branch keeps the
// compiler from overlapping the next (the other loops it unrolls itself);
// the sum keeps its order.
template <int K, bool kData = false, int kUnroll = 1, class D>
__device__ __forceinline__ void ffm(int problem, const D& d,
                                    const int (&i)[K], int v, float (&y)[K],
                                    const float* data = nullptr) {
  if constexpr (kData) {
    ffm_sr<K>(d, i, v, data, y);
    return;
  }
  switch (problem) {
    case kF1:
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float x = d(i[k], 1);
        y[k] = x * (x * x) - 15.0f * (x * x) + 500.0f;
      }
      return;
    case kF2:
#pragma unroll
      for (int k = 0; k < K; ++k)
        y[k] = 8.0f * d(i[k], 0) + (-4.0f * d(i[k], 1) + 1020.0f);
      return;
    case kF3:
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float a = d(i[k], 0), b = d(i[k], 1);
        // clamp_min(q, 0) as PyTorch's: a NaN stays NaN (fmaxf gives 0)
        float q = a * a + b * b;
        y[k] = sqrtf(q < 0.0f ? 0.0f : q);
      }
      return;
    case kSphere:
#pragma unroll
      for (int k = 0; k < K; ++k) y[k] = sphere_term(d(i[k], 0));
      for (int j = 1; j < v; ++j)
#pragma unroll
        for (int k = 0; k < K; ++k) y[k] = y[k] + sphere_term(d(i[k], j));
      return;
    case kRastrigin:
      if constexpr (kUnroll == 2) {
#pragma unroll 2
        for (int j = 0; j < v; ++j)
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float t = rastrigin_term(d(i[k], j));
            y[k] = j ? y[k] + t : t;
          }
        return;
      }
      for (int j = 0; j < v; ++j)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float t = rastrigin_term(d(i[k], j));
          y[k] = j ? y[k] + t : t;
        }
      return;
    case kRosenbrock: {
      float a[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a[k] = d(i[k], 0);
        y[k] = 0.0f;
      }
      for (int j = 0; j + 1 < v; ++j)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float b = d(i[k], j + 1);
          float t = rosenbrock_term(a[k], b);
          y[k] = j ? y[k] + t : t;
          a[k] = b;
        }
      return;
    }
    case kAckley: {
      float s1[K], s2[K];
      for (int j = 0; j < v; ++j)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float a = d(i[k], j);
          float q = a * a;
          float cs = ackley_cos(a);
          s1[k] = j ? s1[k] + q : q;
          s2[k] = j ? s2[k] + cs : cs;
        }
      const float fv = (float)v;
#pragma unroll
      for (int k = 0; k < K; ++k) y[k] = ackley_of(s1[k], s2[k], fv);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)   // unknown id: NaN (the wrapper rejects it)
    y[k] = __int_as_float(0x7fc00000);
}

// Fitness of individual i of the variable-major population x.
template <bool kData, class W>
__device__ __forceinline__ float fitness(const Island<W>& s, const Shape& S,
                                         const W* x, int i) {
  const int one[1] = {i};
  float y[1];
  ffm<1, kData>(S.problem,
                Decoder<W>{x, S.n, (1u << S.c) - 1u, s.lo, s.span}, one,
                S.v, y, s.data);
  return y[0];
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

__device__ __forceinline__ bool fold_warp() {
  return threadIdx.x >= blockDim.x - 32;
}

__device__ __forceinline__ float worst_value(bool minimize) {
  return minimize ? INFINITY : -INFINITY;
}

// Lane 0 of each warp leaves the warp's best (value, index) in
// rval(buf)[warp], ridx(buf)[warp].  Every thread of the block must call it.
template <class W>
__device__ __forceinline__ void warp_partial(const Island<W>& s, int buf,
                                             float bv, int bi, bool minimize) {
  warp_best(bv, bi, minimize);
  if ((threadIdx.x & 31) == 0) {
    s.rval(buf)[threadIdx.x >> 5] = bv;
    s.ridx(buf)[threadIdx.x >> 5] = bi;
  }
}

// The best over the warp partials rval(buf), ridx(buf), in every lane of
// the calling warp.
template <class W>
__device__ __forceinline__ void fold_partials(const Island<W>& s, int buf,
                                              bool minimize, float& bv,
                                              int& bi) {
  const int lane = threadIdx.x & 31, nwarps = (blockDim.x + 31) >> 5;
  bv = lane < nwarps ? s.rval(buf)[lane] : worst_value(minimize);
  bi = lane < nwarps ? s.ridx(buf)[lane] : 0x7fffffff;
  warp_best(bv, bi, minimize);
  bv = __shfl_sync(0xffffffffu, bv, 0);
  bi = __shfl_sync(0xffffffffu, bi, 0);
}

// Index of the best value in y[0..n) (first occurrence) in every thread;
// 0x7fffffff when every value is NaN, with rval(buf), ridx(buf) as scratch.
// Every thread of the block must call it; it ends on a block barrier.
template <class W>
__device__ __forceinline__
int block_best(const Island<W>& s, const float* y, int n, bool minimize,
               int buf) {
  float bv = worst_value(minimize);
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (takes(y[i], i, bv, bi, minimize)) {
      bv = y[i];
      bi = i;
    }
  warp_partial(s, buf, bv, bi, minimize);
  __syncthreads();
  fold_partials(s, buf, minimize, bv, bi);
  __syncthreads();          // the scratch is free again
  return bi;
}

// The migration rule's slot of y[0..n), in every thread: the first
// occurrence of the best value (worst with the sense flipped), or n when
// any value is NaN; rval(buf), ridx(buf) are its scratch.  Every thread
// of the block must call it.
template <class W>
__device__ __forceinline__
int block_slot(const Island<W>& s, const float* y, int n, bool minimize,
               int buf) {
  bool nan = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) nan |= isnan(y[i]);
  const int b = block_best(s, y, n, minimize, buf);
  return __syncthreads_or(nan) ? n : b;
}

// The block's last warp (the fold warp; warp 0 has the mutation rows): fold
// the best of Y(cur) (its warp partials) into the running best, the row
// copied with one lane a variable.  X(cur) is not overwritten before the
// generation's barrier, which the fold warp reaches only after the copy.
template <class W>
__device__ __forceinline__
void fold_best(const Island<W>& s, const Shape& S, int cur) {
  const bool minimize = S.minimize != 0;
  float bv;
  int bi;
  fold_partials(s, cur, minimize, bv, bi);
  const float by = *s.by;
  if (minimize ? bv < by : bv > by) {
    for (int j = threadIdx.x & 31; j < S.v; j += 32)
      s.bx[j] = s.X(cur)[(size_t)j * S.n + bi];
    __syncwarp();           // every lane has read *s.by
    if ((threadIdx.x & 31) == 0) *s.by = bv;
  }
}

// The fold warp: hand the running best to `best_x`/`best_y` and start a
// new fold.
template <class W>
__device__ __forceinline__
void take_best(const Island<W>& s, const Shape& S, uint32_t* best_x,
               float* best_y) {
  for (int j = threadIdx.x & 31; j < S.v; j += 32) {
    best_x[j] = s.bx[j];
    s.bx[j] = 0u;
  }
  if ((threadIdx.x & 31) == 0) {
    *best_y = *s.by;
    *s.by = worst_value(S.minimize != 0);
  }
  __syncwarp();
}

// Copy island `k` of the stack into shared memory (the population
// transposed to [V][N] in buffer 0; kData: the problem's data too) and
// reset the best fold.
template <bool kData, class W>
__device__ __forceinline__
void load_island(const Island<W>& s, const Stack& g, const Shape& S,
                 size_t k) {
  const int n = S.n, v = S.v, half = n / 2, p = S.p;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t ox = k * n * v, osel = k * 2 * n, ocross = k * v * half,
               omut = k * v * n;
  for (int e = tid; e < n * v; e += nt) {
    const int i = e / v, j = e - i * v;
    s.x0[(size_t)j * n + i] = (W)g.x_in[ox + e];
  }
  for (int i = tid; i < 2 * n; i += nt) s.sel[i] = g.sel_in[osel + i];
  for (int i = tid; i < v * half; i += nt) s.cross[i] = g.cross_in[ocross + i];
  for (int e = tid; e < v * p; e += nt) {
    const int j = e / p;
    const size_t o = (size_t)j * n + (e - j * p);
    if (s.gmut)
      s.gmut[o] = g.mut_in[omut + o];
    else
      s.mut[e] = g.mut_in[omut + o];
  }
  for (int j = tid; j < v; j += nt) {
    s.lo[j] = g.lo[j];
    s.span[j] = g.span[j];
    s.bx[j] = 0u;
  }
  if (tid == 0) *s.by = worst_value(S.minimize != 0);
  if constexpr (kData) load_sr_data(s.data, g.data, v);
  __syncthreads();
}

// Write island `k`'s state (population x, fitness y) back; with gmut the
// rows below P are there already.  The mutation
// rows at and past P were never drawn: they leave advanced by `leap`
// clocks, `steps` times the generations run since the load.  The advance
// is linear over GF(2), so a word's is the XOR of the advances of its 8
// nibbles, read from a table of 8 x 16 words built here in the reduction
// scratch (free once the generations are done).  Every thread of the block
// must call it.
template <class W>
__device__ __forceinline__
void store_island(const Island<W>& s, const Stack& g, const Shape& S,
                  size_t k, const W* x, const float* y, int leap,
                  bool track_best) {
  const int n = S.n, v = S.v, half = n / 2, p = S.p;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t ox = k * n * v, osel = k * 2 * n, ocross = k * v * half,
               omut = k * v * n;
  for (int e = tid; e < n * v; e += nt) {
    const int i = e / v, j = e - i * v;
    g.x_out[ox + e] = x[(size_t)j * n + i];
  }
  for (int i = tid; i < 2 * n; i += nt) g.sel_out[osel + i] = s.sel[i];
  for (int i = tid; i < v * half; i += nt) g.cross_out[ocross + i] = s.cross[i];
  uint32_t* nib = (uint32_t*)s.red;
  for (int e = tid; e < 128; e += nt)
    nib[e] = lfsr_advance((uint32_t)(e & 15) << (4 * (e >> 4)), leap);
  __syncthreads();
  for (int j = 0; j < v; ++j)
    for (int a = tid; a < n; a += nt) {
      const size_t o = omut + (size_t)j * n + a;
      if (a >= p) {
        const uint32_t in = g.mut_in[o];
        uint32_t w = 0u;
#pragma unroll
        for (int q = 0; q < 8; ++q) w ^= nib[16 * q + ((in >> (4 * q)) & 15u)];
        g.mut_out[o] = w;
      } else if (!s.gmut) {
        g.mut_out[o] = s.mut[j * p + a];
      }
    }
  for (int i = tid; i < n; i += nt) g.y_out[k * n + i] = y[i];
  if (track_best) {
    for (int j = tid; j < v; j += nt) g.best_x[k * v + j] = s.bx[j];
    if (tid == 0) g.best_y[k] = *s.by;
  }
}

// Fitness of population x[buf] into y[buf] and, with `track_best`, the
// warp partials of y[buf]; ends on a block barrier.  `row` < 0: every row;
// 0 <= row < n: that row alone (a spliced row); row >= n: none, only the
// partials.
template <bool kData, class W>
__device__ __forceinline__
void evaluate(const Island<W>& s, const Shape& S, int buf, bool track_best,
              int row) {
  const bool minimize = S.minimize != 0;
  float bv = worst_value(minimize);
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < S.n; i += blockDim.x) {
    if (row < 0 || i == row)
      s.Y(buf)[i] = fitness<kData>(s, S, s.X(buf), i);
    if (takes(s.Y(buf)[i], i, bv, bi, minimize)) {
      bv = s.Y(buf)[i];
      bi = i;
    }
  }
  if (track_best) warp_partial(s, buf, bv, bi, minimize);
  __syncthreads();
}

// The pair's two children into population words p[0], p[1]: one 8-byte
// store, or one 4-byte store in the 16-bit layout (the words fit: see the
// header).
__device__ __forceinline__ void store_pair(uint32_t* p, uint32_t a,
                                           uint32_t b) {
  *(uint2*)p = make_uint2(a, b);
}

__device__ __forceinline__ void store_pair(uint16_t* p, uint32_t a,
                                           uint32_t b) {
  *(ushort2*)p = make_ushort2((unsigned short)a, (unsigned short)b);
}

// The two-lane form's crossover and mutation for one lane, a call a
// variable: the child of the parents' words *pm and *po at the cut in
// `draw` into *pz, each pointer then a row (n words) down; with kMut, XOR
// the lane's mutation word *mw in (mw is null past P; its rows are
// `mstep` words apart).
template <bool kMut, class W>
struct LaneChild {
  const W* pm;
  const W* po;
  W* pz;
  uint32_t* mw;
  int n, mstep, steps, cut_shift, mut_shift;
  uint32_t c, mask;
  __device__ __forceinline__ void operator()(uint32_t draw) {
    uint32_t cut = draw >> cut_shift;
    cut = cut < c ? cut : c;
    const uint32_t sm = mask >> cut;
    uint32_t z = (*pm & ~sm) | (*po & sm);
    if constexpr (kMut) {
      if (mw) {
        z ^= clock_word(mw, steps) >> mut_shift;
        mw += mstep;
      }
    }
    *pz = (W)z;
    pm += n;
    po += n;
    pz += n;
  }
};

// Every variable's child of one lane: the pair's cut words two at a time,
// lane h clocking variable j + h at *cw (a row pair down each step) and
// the lanes swapping the draws; at V odd the last word is the even
// lane's.
template <bool kMut, class W>
__device__ __forceinline__ void lane_crossover(LaneChild<kMut, W> child,
                                               uint32_t* cw, int v, int h) {
  const int n = child.n;
  int j = 0;
  for (; j + 1 < v; j += 2, cw += n) {
    const uint32_t own = clock_word(cw, child.steps);
    const uint32_t swapped = __shfl_xor_sync(0xffffffffu, own, 1);
    child(h ? swapped : own);
    child(h ? own : swapped);
  }
  if (j < v) {
    const uint32_t own = h ? 0u : clock_word(cw, child.steps);
    const uint32_t swapped = __shfl_xor_sync(0xffffffffu, own, 1);
    child(h ? swapped : own);
  }
}

// The two-lane form's body (see the header) for individual i = threadIdx.x
// of a block of n threads: its tournament, its child of the pair's
// crossover and mutation into X(cur ^ 1), and with `eval` its fitness into
// Y(cur ^ 1), folded into (bv, bi).  Every lane of the block must call it.
template <int kSteps, class W>
__device__ __forceinline__
void lane_child(const Island<W>& s, const Shape& S, bool eval, int cur,
                float& bv, int& bi) {
  const int n = S.n, v = S.v, half = n / 2, p = S.p;
  const int steps = kSteps ? kSteps : S.steps;
  const bool rows_global = kSteps == 0 && s.gmut != nullptr;
  const bool minimize = S.minimize != 0;
  const uint32_t mask = (1u << S.c) - 1u;
  const int sel_shift = 32 - S.idx_bits;
  const W* xc = s.X(cur);
  const float* yc = s.Y(cur);
  W* xn = s.X(cur ^ 1);
  const int i = threadIdx.x, pr = i >> 1, h = i & 1;
  // ---- SM: this lane's tournament, then the partner's winner ------------
  const uint32_t d1 = clock_word(s.sel + i, steps),
                 d2 = clock_word(s.sel + n + i, steps);
  const int i1 = (int)(d1 >> sel_shift), i2 = (int)(d2 >> sel_shift);
  const int mine = (minimize ? yc[i1] <= yc[i2] : yc[i1] >= yc[i2]) ? i1 : i2;
  const int other = __shfl_xor_sync(0xffffffffu, mine, 1);
  // ---- CM + MM: the rows below P only in the warps that hold them --------
  uint32_t* mw = i >= p ? nullptr : rows_global ? s.gmut + i : s.mut + i;
  const int mstep = rows_global ? n : p;
  uint32_t* cw = s.cross + (size_t)h * half + pr;
  if ((i & ~31) < p)
    lane_crossover(LaneChild<true, W>{xc + mine, xc + other, xn + i, mw, n,
                                      mstep, steps, 32 - S.cut_bits,
                                      32 - S.c, (uint32_t)S.c, mask},
                   cw, v, h);
  else
    lane_crossover(LaneChild<false, W>{xc + mine, xc + other, xn + i, mw,
                                       n, mstep, steps, 32 - S.cut_bits,
                                       32 - S.c, (uint32_t)S.c, mask},
                   cw, v, h);
  // ---- FFM of this lane's child, two variables a step --------------------
  if (eval) {
    const int one[1] = {i};
    float y[1];
    ffm<1, false, 2>(S.problem, Decoder<W>{xn, n, mask, s.lo, s.span}, one,
                     v, y);
    s.Y(cur ^ 1)[i] = y[0];
    if (takes(y[0], i, bv, bi, minimize)) {
      bv = y[0];
      bi = i;
    }
  }
}

// One generation of the island in shared memory, from buffer `cur` into
// cur ^ 1, with kSteps LFSR clocks a draw (0: S.steps, read at run time);
// kData: rastrigin_sr's build; kLanes: threads a pair (2: K2's two-lane
// form, `lane_child`).  Every thread of the block must call it; it
// ends on the block barrier after which X(cur ^ 1) holds the offspring
// and, with `eval`, Y(cur ^ 1) their fitness (and, with track_best, its
// warp partials).
template <int kSteps, class W, bool kData, int kLanes = 1>
__device__ __forceinline__
void generation(const Island<W>& s, const Shape& S, bool track_best,
                bool eval, int cur) {
  if constexpr (kLanes == 2) {
    static_assert(!kData, "the two-lane form has no build with data");
    const bool minimize = S.minimize != 0;
    if (track_best && fold_warp()) fold_best(s, S, cur);
    float bv = worst_value(minimize);
    int bi = 0x7fffffff;
    lane_child<kSteps>(s, S, eval, cur, bv, bi);
    if (eval && track_best) warp_partial(s, cur ^ 1, bv, bi, minimize);
    __syncthreads();
    return;
  }
  const int n = S.n, v = S.v, half = n / 2, p = S.p;
  const int steps = kSteps ? kSteps : S.steps;
  // only the run-time form takes mutation rows in global memory: a branch
  // between the two places in the loop below cost the paper's form 6-10%
  // of K1's time on an H100
  const bool rows_global = kSteps == 0 && s.gmut != nullptr;
  const bool minimize = S.minimize != 0;
  const uint32_t mask = (1u << S.c) - 1u;
  const int sel_shift = 32 - S.idx_bits, cut_shift = 32 - S.cut_bits,
            mut_shift = 32 - S.c;
  const W* xc = s.X(cur);
  const float* yc = s.Y(cur);
  W* xn = s.X(cur ^ 1);
  float* yn = s.Y(cur ^ 1);

  if (track_best && fold_warp()) fold_best(s, S, cur);

  float bv = worst_value(minimize);
  int bi = 0x7fffffff;
  for (int pr = threadIdx.x; pr < half; pr += blockDim.x) {
    const int a = 2 * pr, b = a + 1;
    // ---- SM: the pair's two tournaments -----------------------------------
    uint2 d1 = *(const uint2*)(s.sel + a), d2 = *(const uint2*)(s.sel + n + a);
    d1.x = lfsr_advance(d1.x, steps);
    d1.y = lfsr_advance(d1.y, steps);
    d2.x = lfsr_advance(d2.x, steps);
    d2.y = lfsr_advance(d2.y, steps);
    *(uint2*)(s.sel + a) = d1;
    *(uint2*)(s.sel + n + a) = d2;
    int i1 = (int)(d1.x >> sel_shift), i2 = (int)(d2.x >> sel_shift);
    const int wa = (minimize ? yc[i1] <= yc[i2] : yc[i1] >= yc[i2]) ? i1 : i2;
    i1 = (int)(d1.y >> sel_shift);
    i2 = (int)(d2.y >> sel_shift);
    const int wb = (minimize ? yc[i1] <= yc[i2] : yc[i1] >= yc[i2]) ? i1 : i2;
    // ---- CM + MM: per variable, crossover then XOR mutation ---------------
#pragma unroll 4
    for (int j = 0; j < v; ++j) {
      const size_t row = (size_t)j * n;
      uint32_t cut = clock_word(s.cross + (size_t)j * half + pr, steps) >>
                     cut_shift;
      cut = cut < (uint32_t)S.c ? cut : (uint32_t)S.c;
      const uint32_t sm = mask >> cut;
      const uint32_t w1 = xc[row + wa], w2 = xc[row + wb];
      uint32_t z1 = (w1 & ~sm) | (w2 & sm);
      uint32_t z2 = (w2 & ~sm) | (w1 & sm);
      if (a < p)
        z1 ^= (rows_global ? clock_word(s.gmut + row + a, steps)
                           : clock_word(s.mut + j * p + a, steps)) >>
              mut_shift;
      if (b < p)
        z2 ^= (rows_global ? clock_word(s.gmut + row + b, steps)
                           : clock_word(s.mut + j * p + b, steps)) >>
              mut_shift;
      store_pair(xn + row + a, z1, z2);
    }
    // ---- FFM of the two offspring -------------------------------------------
    if (eval) {
      const int ab[2] = {a, b};
      float y[2];
      ffm<2, kData>(S.problem, Decoder<W>{xn, n, mask, s.lo, s.span}, ab, v,
                    y, s.data);
      *(float2*)(yn + a) = make_float2(y[0], y[1]);
      if (takes(y[0], a, bv, bi, minimize)) {
        bv = y[0];
        bi = a;
      }
      if (takes(y[1], b, bv, bi, minimize)) {
        bv = y[1];
        bi = b;
      }
    }
  }
  if (eval && track_best) warp_partial(s, cur ^ 1, bv, bi, minimize);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K1: `gens` generations of each island of the stack, one block an island.
// ---------------------------------------------------------------------------

// kData: rastrigin_sr's builds, whose pair holds 2 x kSRMaxVars values in
// registers; one block an SM may take 128 a thread.
template <int kSteps, bool kData>
__global__ void __launch_bounds__(kMaxThreads, kData ? 1 : kMinBlocks)
ga_generation(const Stack g, const Shape S, int gens, int track_best) {
  extern __shared__ uint32_t smem[];
  const Island<uint32_t> s =
      carve<uint32_t, kData>(smem, S, g.mut_out, blockIdx.x);
  const bool tb = track_best != 0;
  load_island<kData>(s, g, S, blockIdx.x);
  evaluate<kData>(s, S, 0, tb, -1);
  int cur = 0;
  for (int t = 0; t < gens; ++t, cur ^= 1)
    generation<kSteps, uint32_t, kData>(s, S, tb, t + 1 < gens, cur);
  // y: the fitness of the last pre-update population
  store_island(s, g, S, blockIdx.x, s.X(cur), s.Y(cur ^ 1), gens * S.steps,
               tb);
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
// distributed shared memory; y[cur] holds the migration fitness.  Returns
// the slot the block spliced, or n.
template <class W>
__device__ __forceinline__
int ring_step(const Island<W>& s, const Shape& S, const Epoch& E, int cur) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = S.n, v = S.v, tid = threadIdx.x, nt = blockDim.x;
  const int rank = (int)cluster.block_rank();
  const bool minimize = S.minimize != 0;
  W* x = s.X(cur);
  // rval(cur ^ 1) is idle: its partials were folded in the last generation
  const int b = block_slot(s, s.Y(cur), n, minimize, cur ^ 1);
  const int w = block_slot(s, s.Y(cur), n, !minimize, cur ^ 1);
  for (int j = tid; j < v; j += nt)
    s.elite[j] = b < n ? x[(size_t)j * n + b] : 0u;
  cluster.sync();           // every elite of the cluster is in place
  // island `rank` takes the elite of island rank - 1 (island 0: I - 1)
  const uint32_t* src =
      cluster.map_shared_rank(s.elite, (rank + E.islands - 1) % E.islands);
  const bool splice = !(E.boundary && rank == 0) && w < n;
  if (splice)
    for (int j = tid; j < v; j += nt) x[(size_t)j * n + w] = (W)src[j];
  if (E.boundary) {
    const int group = blockIdx.x / E.islands;
    if (rank == E.islands - 1)
      for (int j = tid; j < v; j += nt)
        E.send_elite[(size_t)group * v + j] = s.elite[j];
    if (rank == 0 && tid == 0) E.worst0[group] = w;
  }
  cluster.sync();           // no block overwrites or leaves before its
                            // neighbour has read its elite
  return splice ? w : n;
}

// kLanes: threads a pair (2: the two-lane form, 16-bit builds without data
// only; see the header).
template <int kSteps, class W, bool kData, int kLanes>
__global__ void __launch_bounds__(kMaxThreads, kData ? 1 : kMinBlocks)
ga_epoch(const Stack g, const Shape S, const Epoch E) {
  extern __shared__ uint32_t smem[];
  const Island<W> s = carve<W, kData>(smem, S, g.mut_out, blockIdx.x);
  load_island<kData>(s, g, S, blockIdx.x);
  evaluate<kData>(s, S, 0, true, -1);
  int cur = 0;
  for (int it = 0; it < E.intervals; ++it) {
    for (int t = 0; t < E.migrate_every; ++t, cur ^= 1)
      generation<kSteps, W, kData, kLanes>(s, S, true, true, cur);
    // the interval's best, then a fresh fold for the next interval
    if (fold_warp()) {
      const size_t o = (size_t)it * gridDim.x + blockIdx.x;
      take_best(s, S, g.best_x + o * S.v, g.best_y + o);
    }
    if (E.migrate) {
      const int w = ring_step(s, S, E, cur);
      if (it + 1 < E.intervals) evaluate<kData>(s, S, cur, true, w);
    }
  }
  // y: the final interval's migration fitness (pre-splice)
  store_island(s, g, S, blockIdx.x, s.X(cur), s.Y(cur),
               E.intervals * E.migrate_every * S.steps, false);
}

// ---------------------------------------------------------------------------
// K3: streamed epochs.  Block b of a launch takes group group0 + b / (I / T)
// and walks its T islands; with `splice` a launch runs `intervals`
// intervals and the ring between them (see the header).
// ---------------------------------------------------------------------------

struct Streamed {
  int groups, islands, tile, migrate_every, intervals, migrate, splice;
  int group0;                // the first group of this launch (a wave)
  uint32_t* elite;           // [2, G, I, V] elites by interval parity
                             // (without splice: [G, I, V], the output)
  int* worst;                // [G, I] worst slots (without splice: output)
  unsigned* arrived;         // [G] barrier counters, zero at launch
};

// Arrive at the barrier of a group and wait until `target` blocks have:
// release on arrive, acquire on wait, at device scope.  Every thread of the
// block must call it.
__device__ __forceinline__ void group_barrier(unsigned* arrived,
                                              unsigned target) {
  __syncthreads();          // the block's writes precede thread 0's arrive
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(arrived) : "memory");
    unsigned seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(arrived) : "memory");
      if (seen >= target) break;
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Island `k`'s elite (b: its slot, n for none, which gives zeros) into
// `dst`, and its worst slot `w` into *worst.
template <class W>
__device__ __forceinline__
void send_elite(const Island<W>& s, const Shape& S, int cur, int b, int w,
                uint32_t* dst, int* worst) {
  for (int j = threadIdx.x; j < S.v; j += blockDim.x)
    dst[j] = b < S.n ? s.X(cur)[(size_t)j * S.n + b] : 0u;
  if (threadIdx.x == 0) *worst = w;
}

template <int kSteps, bool kData>
__global__ void __launch_bounds__(kMaxThreads, kData ? 1 : kMinBlocks)
ga_streamed_epoch(const Stack g, const Shape S, const Streamed T) {
  extern __shared__ uint32_t smem[];
  const int n = S.n, v = S.v, tid = threadIdx.x, nt = blockDim.x;
  const bool minimize = S.minimize != 0;
  const bool ring = T.migrate && T.splice;
  // T = 1: the island stays in shared memory for every interval
  const bool keep = T.tile == 1;
  const int tiles = T.islands / T.tile;
  const int group = T.group0 + blockIdx.x / tiles;
  const int first = (blockIdx.x % tiles) * T.tile;
  const size_t all = (size_t)T.groups * T.islands;
  unsigned* arrived = T.arrived + group;
  int cur = 0;
  for (int it = 0; it < T.intervals; ++it) {
    const uint32_t* sent = T.elite + (size_t)(it & 1) * all * v;
    for (int t = 0; t < T.tile; ++t) {
      const int i = first + t;
      const size_t k = (size_t)group * T.islands + i;
      const size_t from = (size_t)group * T.islands +
                          (i + T.islands - 1) % T.islands;
      const Island<uint32_t> s = carve<uint32_t, kData>(smem, S, g.mut_out,
                                                        k);
      // from the second interval on, a walking block reloads what it
      // stored (a value, not a reference: no stack frame)
      Stack src = g;
      if (it) {
        src.x_in = g.x_out;
        src.sel_in = g.sel_out;
        src.cross_in = g.cross_out;
        src.mut_in = g.mut_out;
      }
      if (!keep || it == 0) {
        load_island<kData>(s, src, S, k);
        if (ring && it > 0) {       // the splice pending since the last
          const int w = T.worst[k]; // interval
          const uint32_t* e = T.elite + ((size_t)((it - 1) & 1) * all +
                                         from) * v;
          if (w < n)
            for (int j = tid; j < v; j += nt)
              s.x0[(size_t)j * n + w] = __ldcg(e + j);
          __syncthreads();
        }
        evaluate<kData>(s, S, 0, true, -1);
        cur = 0;
      }
      for (int e = 0; e < T.migrate_every; ++e, cur ^= 1)
        generation<kSteps, uint32_t, kData>(s, S, true, true, cur);
      // the interval's best, then a fresh fold for the next interval
      if (fold_warp()) {
        const size_t o = (size_t)it * all + k;
        take_best(s, S, g.best_x + o * v, g.best_y + o);
      }
      int w = n;
      if (T.migrate) {              // y[cur]: the migration fitness
        const int b = block_slot(s, s.Y(cur), n, minimize, cur ^ 1);
        w = block_slot(s, s.Y(cur), n, !minimize, cur ^ 1);
        send_elite(s, S, cur, b, w,
                   T.elite + ((size_t)(it & 1) * all + k) * v, T.worst + k);
      }
      if (!keep) {
        store_island(s, src, S, k, s.X(cur), s.Y(cur),
                     T.migrate_every * S.steps, false);
        __syncthreads();            // the next island's load overwrites
                                    // what the store reads
      } else if (ring) {
        group_barrier(arrived, (unsigned)(it + 1) * tiles);
        const uint32_t* e = sent + from * v;
        if (w < n)
          for (int j = tid; j < v; j += nt)
            s.X(cur)[(size_t)j * n + w] = __ldcg(e + j);
        __syncthreads();            // the row is whole before it is read
        if (it + 1 < T.intervals) evaluate<kData>(s, S, cur, true, w);
      }
    }
    if (!keep && ring) group_barrier(arrived, (unsigned)(it + 1) * tiles);
  }
  if (keep) {
    // y: the final interval's migration fitness (pre-splice)
    const size_t k = (size_t)group * T.islands + first;
    const Island<uint32_t> s = carve<uint32_t, kData>(smem, S, g.mut_out, k);
    store_island(s, g, S, k, s.X(cur), s.Y(cur),
                 T.intervals * T.migrate_every * S.steps, false);
  } else if (ring) {
    // the last interval's splice, in global memory
    const uint32_t* sent =
        T.elite + (size_t)((T.intervals - 1) & 1) * all * v;
    for (int t = 0; t < T.tile; ++t) {
      const int i = first + t;
      const size_t k = (size_t)group * T.islands + i;
      const size_t from = (size_t)group * T.islands +
                          (i + T.islands - 1) % T.islands;
      const int w = T.worst[k];
      if (w < n)
        for (int j = tid; j < v; j += nt)
          g.x_out[(k * n + w) * v + j] = __ldcg(sent + from * v + j);
    }
  }
}

// ---------------------------------------------------------------------------
// The global-memory form of K1.  The one-block form above keeps a replica in
// one block's shared memory, so it refuses a replica past 227 KB (N = 8192
// at V = 1 down to N = 256 at V = 64) and a fitness it has no FFM stage for
// (a blackbox or a problem the user registered).  The TPU kernel takes both:
// its population lives in VMEM, which holds megabytes, and it traces any
// fitness into its body.  Here one generation of a stack [R, N, V] is three
// kernels that leave the state in global memory, in the wrappers' layouts;
// each replaces a part of src/repro/kernels/ga_step.py:600
// `ga_generation_kernel` in this form:
//
//   ga_ffm        y [R, N] of x: the built-in problems' FFM, a block a
//                 tile of rows in shared memory (for any other fitness the
//                 wrapper calls its PyTorch stage instead: CUDA cannot take
//                 a Python function, and the stage is what the reference
//                 runs);
//   ga_best       the running best (best_y [R], best_x [R, V]) folded with
//                 x's best, with `takes`' first-occurrence rule and strict
//                 improvement; a NaN anywhere in y leaves it as it was (the
//                 plain version's argmin picks the NaN, which its strict
//                 compare refuses);
//   ga_operators  x' and the banks advanced one generation from x and y, as
//                 `generation` runs it: two tournaments a pair, the
//                 crossover of each variable, the XOR mutation of the rows
//                 below P, parents read at any index.  Every word of the
//                 mutation bank is clocked, as the plain version clocks it
//                 (the one-block form leaps the rows at and past P once at
//                 its store).
//
// A kernel boundary orders the steps; the wrapper launches the three once a
// generation.  Each is bound by the bytes it moves, at a few integer
// operations a word, far below the card's issue rate.  Built with the
// flags of the whole file, so the FFM rounds as the plain version does.
//
// ga_ffm reads x (4RNV bytes) and writes y (4RN): 12.6 MB at rastrigin:2,
// N = 65536 x 16, 3.8 us at 3.35 TB/s; its work is the decode and the
// problem's float32 expression, with a precise cosf (about 25 instructions,
// no MUFU) a variable for rastrigin and ackley.  A thread a row walking it
// in global memory put a warp's lanes V words apart (at V = 64 a load
// touched 32 sectors for 128 useful bytes) and left the card idle where
// R*N is small (rastrigin:32, N = 1024 x 16: 16384 threads, 32 cosf each
// one after another).  The plain version sums the V terms from left to
// right, the first not added to 0 (float32 addition is not associative),
// so no sum over V may be a tree: only the terms may run in parallel.  A
// block takes a tile of T consecutive rows of x seen as one [R*N, V]
// matrix (every replica shares lo and span; the last tile may be ragged);
// the wrapper's `ffm_spreads` and `ffm_tiling` pick the form, T and the
// chunk Vc, and the launcher checks them:
//   1. the block copies the words [j0, j0 + Vc) of its T rows into shared
//      memory, consecutive threads on consecutive words of a row (when Vc
//      = V one contiguous range, 16 bytes a thread where aligned, two loads
//      of a thread in flight before its stores), at the odd row stride of
//      `ffm_stride`, so lanes walking down a column hit distinct banks, and
//      the chunk's lo and span beside them;
//   2. rows form (V < 4, F1-F3 always, and wherever 256-row tiles alone
//      fill the grid): a thread takes K = T / 256 rows, 256 apart, and runs
//      `ffm<K>` over them, interleaved, so their cosf chains overlap;
//   3. spread form (sphere to ackley, where R*N is small): for rastrigin
//      and ackley a thread a (row, variable) item, rows fastest, decodes its
//      word and writes its term into a second tile (ackley: a*a there, its
//      cos over the word) and a barrier follows; then a thread a row folds
//      the chunk's terms from left to right into sums it carries in
//      registers to the next chunk, the first term of the row not added to
//      0, and ackley finishes with `ackley_of`.  Sphere's b*b and
//      rosenbrock's seven operations cost the folding thread less than a
//      pass that spreads them (measured), so it computes them itself;
//      rosenbrock's term j reads word j + 1, so a chunk short of V loads one
//      halo word past its end, and at V = 1 the sum is 0.
// Every term is `ffm`'s own expression (the shared `*_term` functions), so
// y is the plain version's bit for bit, NaN and inf included.  The spread
// form is built once a problem, so sphere and rosenbrock (no cosf) fit 32
// registers.
//
// ga_operators moves N*V + 2N + V*N/2 + V*N words a replica each way and
// reads y: 62.9 MB at rastrigin:2, N = 65536 x 16, 18.8 us at 3.35 TB/s.
// A thread a pair looping over V would put a child's words 2V apart across
// a warp's lanes and read one word of a random row a lane: at V >= 8 a
// store touches 32 sectors for 128 useful bytes.  So a block takes a tile
// of T consecutive pairs of one replica and a chunk of Vc variables (the
// wrapper's `operators_tiling` picks both, the launcher checks them), and
// every global access of x, x' and the banks is contiguous across a warp:
//   1. a thread a pair loads its two selection words of each bank row as
//      one 8-byte word, clocks them and runs the two tournaments; the
//      winners go to shared memory (only chunk 0 stores the clocked bank,
//      the other chunks recompute the same winners);
//   2. the block copies the words [j0, j0 + Vc) of the 2T parent rows into
//      the tile, consecutive threads on consecutive words of a row;
//   3. a thread a (pair, variable), pairs fastest, clocks cross[j, pr] and
//      mut[j, a..a+1] (one 8-byte word), so the banks are read and written
//      along N, and crosses and mutates the pair's two slots in place (no
//      other thread reads them); the row stride Vc | 1 is odd, so the
//      lanes' slots fall in distinct banks;
//   4. the 2T children are rows 2*pr0 .. 2*pr0 + 2T - 1 of x': when Vc = V
//      one contiguous range, stored 16 bytes a thread where aligned, else
//      a contiguous chunk a row.
// A tile stays within 27 KB and a thread within 32 registers (8 bytes
// spill; uncapped it takes 47, five blocks an SM), so eight blocks of 256
// threads share an SM; the wrapper halves the tile while the grid is short
// of 512 blocks, down to 512 items a tile (scripts/torch_global_tiles_sweep.py
// times the tiles around its choice on a card).
//
// ga_best reads y (4N bytes a replica) and one row; a block a replica would
// leave most SMs idle at a few replicas (16 of 132 at R = 16).  So a
// replica is one thread-block cluster of B <= kMaxCluster blocks (the
// wrapper's `best_split` picks B and the slice length):
//   1. each block folds a contiguous slice of the replica's y with 16-byte
//      loads (a scalar head and tail where the row is not aligned: N is
//      only even), keeping `takes`' rule and a NaN flag, and leaves its
//      partial (value, index, NaN) in its own shared memory;
//   2. after a cluster barrier, rank 0 reads the B partials through
//      distributed shared memory, one lane a rank, and folds them with the
//      same rule, so the result is the same whatever order the blocks ran
//      in; a second barrier keeps every block (and its shared memory)
//      alive until then;
//   3. rank 0 compares strictly with by_in and copies the row of x or of
//      bx_in with all its threads.
// ---------------------------------------------------------------------------

constexpr int kGlobalThreads = 256;  // ga_ffm and ga_operators
constexpr int kFfmSmemLimit = 49152; // bytes of a ga_ffm block (no opt-in)
constexpr int kFfmLoads = 2;         // 16-byte loads a thread has in flight
constexpr int kBestThreads = 512;    // ga_best: a block a slice of a replica
constexpr int kOpsBlocks = 8;        // ga_operators blocks an SM holds
constexpr int kOpsSmemLimit = 27648; // bytes of a tile: 8 x (27 + 1) KB an SM

// Words of a ga_operators tile of `tile` pairs and `chunk` variables: the
// 2T parent (then child) rows at the odd stride chunk | 1, and 2T winners.
__host__ __device__ inline size_t ops_tile_words(int tile, int chunk) {
  return 2 * (size_t)tile * (chunk | 1) + 2 * (size_t)tile;
}

// A walk over the words w = k * width + j of a row-major range, `step`
// words at a time, without a division a step.
struct RowWalk {
  int k, j, dk, dj, width;
  __device__ __forceinline__ RowWalk(int w, int step, int width_)
      : k(w / width_), j(w - (w / width_) * width_), dk(step / width_),
        dj(step - (step / width_) * width_), width(width_) {}
  __device__ __forceinline__ void next() {
    k += dk;
    j += dj;
    if (j >= width) {
      j -= width;
      ++k;
    }
  }
  __device__ __forceinline__ void next_word() {
    if (++j == width) {
      j = 0;
      ++k;
    }
  }
};

// Row stride of a ga_ffm tile of `chunk` variables: odd, and in the spread
// form one word longer than a chunk for rosenbrock's halo.
__host__ __device__ inline int ffm_stride(int chunk, bool spread) {
  return spread ? (chunk + 1) | 1 : chunk | 1;
}

// Bytes of a ga_ffm block's shared memory: `tile` rows of words at the
// stride above, the chunk's lo and span, and in the spread form a tile of
// terms.
__host__ __device__ inline size_t ffm_tile_bytes(int tile, int chunk,
                                                 bool spread) {
  const size_t words = (size_t)tile * ffm_stride(chunk, spread);
  return 4 * ((spread ? 2 : 1) * words + 2 * (size_t)(chunk + 1));
}

// Step 1 of ga_ffm: the words [j0, j0 + width) of the `here` rows of x at
// `src` = x + row0 * v + j0 into tile row k at k * stride (one contiguous
// range when width = v, read 16 bytes a thread where aligned, else a
// contiguous chunk a row; every load of a thread in flight before its
// first store), and lo, span [j0, j0 + width) beside them.
__device__ __forceinline__ void ffm_load(const uint32_t* src, int here,
                                         int v, int width, uint32_t* tile,
                                         int stride, const float* lo,
                                         const float* span, float* tlo,
                                         float* tspan) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int words = here * width;
  for (int j = tid; j < width; j += nt) {
    tlo[j] = __ldg(lo + j);
    tspan[j] = __ldg(span + j);
  }
  if (width == v) {
    const int head =
        min(words, (int)((16 - ((uintptr_t)src & 15)) & 15) >> 2);
    const int body = (words - head) >> 2;
    if (tid < head) {
      RowWalk at(tid, nt, v);
      tile[at.k * stride + at.j] = __ldg(src + tid);
    }
    const uint4* src4 = (const uint4*)(src + head);
    RowWalk at(head + 4 * tid, 4 * nt, v);
    for (int q0 = tid; q0 < body; q0 += kFfmLoads * nt) {
      uint4 u[kFfmLoads];
#pragma unroll
      for (int m = 0; m < kFfmLoads; ++m)
        if (q0 + m * nt < body) u[m] = __ldg(src4 + q0 + m * nt);
#pragma unroll
      for (int m = 0; m < kFfmLoads; ++m, at.next()) {
        if (q0 + m * nt >= body) break;
        RowWalk e = at;
        tile[e.k * stride + e.j] = u[m].x;
        e.next_word();
        tile[e.k * stride + e.j] = u[m].y;
        e.next_word();
        tile[e.k * stride + e.j] = u[m].z;
        e.next_word();
        tile[e.k * stride + e.j] = u[m].w;
      }
    }
    const int w = head + 4 * body + tid;
    if (w < words) {
      RowWalk t(w, nt, v);
      tile[t.k * stride + t.j] = __ldg(src + w);
    }
  } else {
    RowWalk at(tid, nt, width);
    for (int w0 = tid; w0 < words; w0 += 4 * kFfmLoads * nt) {
      uint32_t u[4 * kFfmLoads];
      RowWalk e = at;
#pragma unroll
      for (int m = 0; m < 4 * kFfmLoads; ++m, e.next())
        if (w0 + m * nt < words) u[m] = __ldg(src + (size_t)e.k * v + e.j);
#pragma unroll
      for (int m = 0; m < 4 * kFfmLoads; ++m, at.next())
        if (w0 + m * nt < words) tile[at.k * stride + at.j] = u[m];
    }
  }
}

// Step 3 of ga_ffm's spread form for problem P: the terms of a chunk
// (`terms` a row), item q = (row q mod T, variable q / T), into t (ackley's
// cos over its word in w).
template <int P>
__device__ __forceinline__ void ffm_terms(uint32_t* w, float* t, int tile,
                                          int here, int stride, int terms,
                                          uint32_t mask, const float* lo,
                                          const float* span) {
  const int lg = __ffs(tile) - 1;
#pragma unroll 4
  for (int q = threadIdx.x; q < (terms << lg); q += blockDim.x) {
    const int k = q & (tile - 1), jj = q >> lg;
    if (k >= here) continue;
    const int at = k * stride + jj;
    const float a = lo[jj] + (float)(w[at] & mask) * span[jj];
    if constexpr (P == kSphere) {
      t[at] = sphere_term(a);
    } else if constexpr (P == kRastrigin) {
      t[at] = rastrigin_term(a);
    } else if constexpr (P == kRosenbrock) {
      const float b = lo[jj + 1] + (float)(w[at + 1] & mask) * span[jj + 1];
      t[at] = rosenbrock_term(a, b);
    } else {
      t[at] = a * a;
      w[at] = __float_as_uint(ackley_cos(a));
    }
  }
}

// y[row]: the FFM of each row of x [rows, v] (rows = R * N), a block the
// tile of `tile` rows from blockIdx.x * tile, in the steps of the note
// above.  K > 0: the rows form (tile = 256 K, chunk = v, the problem at run
// time; P = kRastriginSR: that problem, K = 1, its `data` first in the
// block); K = 0: the spread form for problem P (tile a power of two <= 256,
// chunks of `chunk` variables).  The forms without cosf hold 8 blocks an
// SM; rastrigin_sr's, with 2 x kSRMaxVars values a thread, 2.
template <int K, int P>
__global__ void __launch_bounds__(kGlobalThreads,
                                  P == kRastriginSR ? 2
                                  : K == 0 && (P == kSphere ||
                                               P == kRosenbrock) ? 8 : 4)
ga_ffm(const uint32_t* x, float* y, const float* lo, const float* span,
       size_t rows, int v, int c, int problem, int tile, int chunk,
       const float* data) {
  extern __shared__ uint32_t smem[];
  constexpr bool spread = K == 0;
  constexpr bool kData = P == kRastriginSR;
  const int stride = ffm_stride(chunk, spread);
  float* sdata = (float*)smem;                          // kData: the data
  uint32_t* w = smem + (kData ? data_words(kRastriginSR, v) : 0);  // words
  float* t = (float*)(w + (size_t)tile * stride);       // the terms
  float* tlo = (float*)(w + (size_t)(spread ? 2 : 1) * tile * stride);
  float* tspan = tlo + chunk + 1;
  const size_t row0 = (size_t)blockIdx.x * tile, left = rows - row0;
  const int here = left < (size_t)tile ? (int)left : tile;
  const uint32_t mask = (1u << c) - 1u;
  const int tid = threadIdx.x;
  const uint32_t* src = x + row0 * v;
  if constexpr (K > 0) {
    if constexpr (kData) load_sr_data(sdata, data, v);
    ffm_load(src, here, v, v, w, stride, lo, span, tlo, tspan);
    __syncthreads();
    int i[K];
    float out[K];
#pragma unroll
    for (int k = 0; k < K; ++k) i[k] = tid + k * kGlobalThreads;
    ffm<K, kData>(problem, TileDecoder{w, stride, mask, tlo, tspan}, i, v,
                  out, sdata);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (i[k] < here) y[row0 + i[k]] = out[k];
  } else {
    // rastrigin's and ackley's cosf terms are spread over the block; sphere's
    // and rosenbrock's cost the folding thread less than a pass
    constexpr bool cos_terms = P == kRastrigin || P == kAckley;
    float s1 = 0.0f, s2 = 0.0f;   // the carried sums (s2: ackley's cos)
    for (int j0 = 0; j0 < v; j0 += chunk) {
      const int vc = min(chunk, v - j0);
      const int width = P == kRosenbrock ? min(vc + 1, v - j0) : vc;
      const int terms = P == kRosenbrock ? width - 1 : vc;
      if (j0 > 0) __syncthreads();   // the last chunk's fold is done
      ffm_load(src + j0, here, v, width, w, stride, lo + j0, span + j0, tlo,
               tspan);
      __syncthreads();
      if constexpr (cos_terms) {
        ffm_terms<P>(w, t, tile, here, stride, terms, mask, tlo, tspan);
        __syncthreads();
      }
      if (tid < here && terms > 0) {   // the fold, a thread a row
        const uint32_t* wk = w + tid * stride;
        const float* tk = t + tid * stride;
        auto word = [&](int jj) {
          return tlo[jj] + (float)(wk[jj] & mask) * tspan[jj];
        };
        int jj = 0;
        if constexpr (P == kSphere) {
          if (j0 == 0) s1 = sphere_term(word(jj++));   // the first term is
#pragma unroll 8                                       // the sum, not 0 + it
          for (; jj < terms; ++jj) s1 = s1 + sphere_term(word(jj));
        } else if constexpr (P == kRosenbrock) {
          float a = word(0);
          if (j0 == 0) {
            const float b = word(1);
            s1 = rosenbrock_term(a, b);
            a = b;
            jj = 1;
          }
#pragma unroll 4
          for (; jj < terms; ++jj) {
            const float b = word(jj + 1);
            s1 = s1 + rosenbrock_term(a, b);
            a = b;
          }
        } else {
          if (j0 == 0) {
            s1 = tk[0];
            if constexpr (P == kAckley) s2 = __uint_as_float(wk[0]);
            jj = 1;
          }
          if constexpr (P == kAckley) {
#pragma unroll 4
            for (; jj < terms; ++jj) {
              s1 = s1 + tk[jj];
              s2 = s2 + __uint_as_float(wk[jj]);   // its cos terms
            }
          } else {
#pragma unroll 8
            for (; jj < terms; ++jj) s1 = s1 + tk[jj];
          }
        }
      }
    }
    if (tid < here) {
      if constexpr (P == kAckley)
        y[row0 + tid] = ackley_of(s1, s2, (float)v);
      else
        y[row0 + tid] = s1;
    }
  }
}

// Launch ga_ffm<K, P>, a block a tile of rows.
template <int K, int P>
cudaError_t ffm_run(const uint32_t* x, float* y, const float* lo,
                    const float* span, size_t rows, int v, int c,
                    int problem, int tile, int chunk, size_t smem,
                    cudaStream_t s, const float* data = nullptr) {
  const unsigned blocks = (unsigned)((rows + tile - 1) / tile);
  ga_ffm<K, P><<<blocks, kGlobalThreads, smem, s>>>(
      x, y, lo, span, rows, v, c, problem, tile, chunk, data);
  return cudaGetLastError();
}

// The banks of a stack in global memory, in and out.
struct Operators {
  const uint32_t* x;      // [R, N, V] the population
  const float* y;         // [R, N]    its fitness
  const uint32_t* sel;    // [R, 2, N]
  const uint32_t* cross;  // [R, V, N/2]
  const uint32_t* mut;    // [R, V, N]
  uint32_t* x_out;        // the offspring
  uint32_t* sel_out;      // the banks, each word clocked by S.steps
  uint32_t* cross_out;
  uint32_t* mut_out;
};

// SM, CM and MM of one generation.  Block (b, chunk) of the grid
// (R * N/2 / tile, ceil(V / chunk)) takes pairs [pr0, pr0 + tile) of
// replica b / (N/2 / tile) and variables [j0, j0 + chunk), in the four
// steps of the note above.  tile is a power of two dividing N/2.
__global__ void __launch_bounds__(kGlobalThreads, kOpsBlocks)
ga_operators(const Operators O, const Shape S, int tile, int chunk) {
  extern __shared__ uint32_t smem[];
  const int n = S.n, v = S.v, half = n / 2, p = S.p, steps = S.steps;
  const int tiles = half / tile;
  const size_t r = blockIdx.x / tiles;
  const int pr0 = (int)(blockIdx.x - r * tiles) * tile;
  const int j0 = blockIdx.y * chunk;
  const int vc = min(chunk, v - j0), stride = chunk | 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  // rows [0, tile): the first parents (then children a), [tile, 2 tile):
  // the second (then children b); win: the parents' indices, in that order
  uint32_t* rows = smem;
  int* win = (int*)(smem + 2 * (size_t)tile * stride);
  const bool minimize = S.minimize != 0;
  // ---- 1. SM: a thread a pair, its two tournaments ------------------------
  {
    const float* y = O.y + r * n;
    const int sel_shift = 32 - S.idx_bits;
    for (int q = tid; q < tile; q += nt) {
      const size_t at0 = r * 2 * n + 2 * (pr0 + q), at1 = at0 + n;
      uint2 d0 = *(const uint2*)(O.sel + at0);   // sel[0, a], sel[0, b]
      uint2 d1 = *(const uint2*)(O.sel + at1);   // sel[1, a], sel[1, b]
      d0.x = lfsr_advance(d0.x, steps);
      d0.y = lfsr_advance(d0.y, steps);
      d1.x = lfsr_advance(d1.x, steps);
      d1.y = lfsr_advance(d1.y, steps);
      if (blockIdx.y == 0) {
        *(uint2*)(O.sel_out + at0) = d0;
        *(uint2*)(O.sel_out + at1) = d1;
      }
      const int i1 = (int)(d0.x >> sel_shift), i2 = (int)(d1.x >> sel_shift);
      const int i3 = (int)(d0.y >> sel_shift), i4 = (int)(d1.y >> sel_shift);
      const float y1 = __ldg(y + i1), y2 = __ldg(y + i2);
      const float y3 = __ldg(y + i3), y4 = __ldg(y + i4);
      win[q] = (minimize ? y1 <= y2 : y1 >= y2) ? i1 : i2;
      win[tile + q] = (minimize ? y3 <= y4 : y3 >= y4) ? i3 : i4;
    }
  }
  __syncthreads();
  // ---- 2. the parents' words [j0, j0 + vc) into the tile ------------------
  const uint32_t* x = O.x + r * n * v + j0;
  const int words = 2 * tile * vc;
  {
    RowWalk at(tid, nt, vc);
#pragma unroll 4
    for (int w = tid; w < words; w += nt, at.next())
      rows[at.k * stride + at.j] = __ldg(x + (size_t)win[at.k] * v + at.j);
  }
  __syncthreads();
  // ---- 3. CM + MM: a thread a (pair, variable), pairs fastest -------------
  {
    const uint32_t mask = (1u << S.c) - 1u;
    const int cut_shift = 32 - S.cut_bits, mut_shift = 32 - S.c;
    const int lg = __ffs(tile) - 1;
    const size_t ocross = r * v * half, omut = r * v * n;
    for (int q = tid; q < tile * vc; q += nt) {
      const int pq = q & (tile - 1), jj = q >> lg, j = j0 + jj;
      const int pr = pr0 + pq, a = 2 * pr;
      const size_t oc = ocross + (size_t)j * half + pr;
      const uint32_t cw = lfsr_advance(O.cross[oc], steps);
      O.cross_out[oc] = cw;
      uint32_t cut = cw >> cut_shift;
      cut = cut < (uint32_t)S.c ? cut : (uint32_t)S.c;
      const uint32_t sm = mask >> cut;
      uint32_t* s1 = rows + pq * stride + jj;
      uint32_t* s2 = rows + (tile + pq) * stride + jj;
      const uint32_t w1 = *s1, w2 = *s2;
      uint32_t z1 = (w1 & ~sm) | (w2 & sm);
      uint32_t z2 = (w2 & ~sm) | (w1 & sm);
      const size_t om = omut + (size_t)j * n + a;
      uint2 m = *(const uint2*)(O.mut + om);     // mut[j, a], mut[j, b]
      m.x = lfsr_advance(m.x, steps);
      m.y = lfsr_advance(m.y, steps);
      *(uint2*)(O.mut_out + om) = m;
      if (a < p) z1 ^= m.x >> mut_shift;
      if (a + 1 < p) z2 ^= m.y >> mut_shift;
      *s1 = z1;
      *s2 = z2;
    }
  }
  __syncthreads();
  // ---- 4. the children: rows 2 pr0 .. 2 pr0 + 2 tile - 1 of x' ------------
  // child row k is child a (k even) or b (k odd) of pair k / 2
  uint32_t* out = O.x_out + (r * n + 2 * (size_t)pr0) * v + j0;
  auto child = [&](const RowWalk& at) {
    return rows[((at.k & 1) * tile + (at.k >> 1)) * stride + at.j];
  };
  if (vc == v) {   // one contiguous range of 2 tile V words
    const int head =
        min(words, (int)((16 - ((uintptr_t)out & 15)) & 15) >> 2);
    const int body = (words - head) >> 2;
    if (tid < head) {
      RowWalk at(tid, nt, v);
      out[tid] = child(at);
    }
    RowWalk at(head + 4 * tid, 4 * nt, v);
    for (int q = tid; q < body; q += nt, at.next()) {
      RowWalk e = at;
      uint4 u;
      u.x = child(e);
      e.next_word();
      u.y = child(e);
      e.next_word();
      u.z = child(e);
      e.next_word();
      u.w = child(e);
      *(uint4*)(out + head + 4 * q) = u;
    }
    const int w = head + 4 * body + tid;
    if (w < words) {
      RowWalk t(w, nt, v);
      out[w] = child(t);
    }
  } else {         // a contiguous chunk a row
    RowWalk at(tid, nt, vc);
    for (int w = tid; w < words; w += nt, at.next())
      out[(size_t)at.k * v + at.j] = child(at);
  }
}

// One value of a slice into a thread's running (first-occurrence) best and
// NaN flag.
__device__ __forceinline__ void see_value(float yi, int i, float& bv,
                                          int& bi, bool& nan, bool mini) {
  nan |= isnan(yi);
  if (takes(yi, i, bv, bi, mini)) {
    bv = yi;
    bi = i;
  }
}

// The running best of each replica folded with the best of (x, y): a
// cluster of B blocks a replica, block `rank` folding y[rank * slice,
// min(N, (rank + 1) * slice)) (see the note above).  by_out, bx_out may
// alias by_in, bx_in.
__global__ void __launch_bounds__(kBestThreads)
ga_best(const uint32_t* x, const float* y, const float* by_in,
        const uint32_t* bx_in, float* by_out, uint32_t* bx_out, int n,
        int v, int slice, int minimize) {
  __shared__ float wv[kBestThreads / 32];
  __shared__ int wi[kBestThreads / 32];
  __shared__ float part_v;     // this block's best of its slice
  __shared__ int part_i, part_nan;
  __shared__ float fin_v;      // rank 0: the replica's best
  __shared__ int fin_i, fin_nan;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const size_t r = blockIdx.x / blocks;
  const bool mini = minimize != 0;
  const float old = rank == 0 ? by_in[r] : 0.0f;   // read before any write
  const float* yr = y + r * n;
  const int tid = threadIdx.x;
  const int lo = rank * slice, len = min(n, lo + slice) - lo;
  float bv = worst_value(mini);
  int bi = 0x7fffffff;
  bool nan = false;
  if (len > 0) {
    const int head =
        min(len, (int)((16 - ((uintptr_t)(yr + lo) & 15)) & 15) >> 2);
    const int body = (len - head) >> 2, tail = head + 4 * body;
    const float4* y4 = (const float4*)(yr + lo + head);
    if (tid < head) see_value(yr[lo + tid], lo + tid, bv, bi, nan, mini);
    for (int q = tid; q < body; q += blockDim.x) {
      const float4 f = __ldg(y4 + q);
      const int i = lo + head + 4 * q;
      see_value(f.x, i, bv, bi, nan, mini);
      see_value(f.y, i + 1, bv, bi, nan, mini);
      see_value(f.z, i + 2, bv, bi, nan, mini);
      see_value(f.w, i + 3, bv, bi, nan, mini);
    }
    if (tail + tid < len)
      see_value(yr[lo + tail + tid], lo + tail + tid, bv, bi, nan, mini);
  }
  warp_best(bv, bi, mini);
  if ((threadIdx.x & 31) == 0) {
    wv[threadIdx.x >> 5] = bv;
    wi[threadIdx.x >> 5] = bi;
  }
  nan = __syncthreads_or(nan);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {      // warp 0 folds the warp partials
    const int nwarps = blockDim.x >> 5;
    bv = lane < nwarps ? wv[lane] : worst_value(mini);
    bi = lane < nwarps ? wi[lane] : 0x7fffffff;
    warp_best(bv, bi, mini);
    if (lane == 0) {
      part_v = bv;
      part_i = bi;
      part_nan = nan;
    }
  }
  cluster.sync();              // every block's partial is in place
  if (rank == 0 && threadIdx.x < 32) {   // one lane a rank
    float pv = worst_value(mini);
    int pi = 0x7fffffff;
    bool pn = false;
    if (lane < blocks) {
      pv = *cluster.map_shared_rank(&part_v, lane);
      pi = *cluster.map_shared_rank(&part_i, lane);
      pn = *cluster.map_shared_rank(&part_nan, lane) != 0;
    }
    warp_best(pv, pi, mini);
    pn = __any_sync(0xffffffffu, pn);
    if (lane == 0) {
      fin_v = pv;
      fin_i = pi;
      fin_nan = pn;
    }
  }
  cluster.sync();              // no block leaves before rank 0 has read it
  if (rank != 0) return;
  const bool better = !fin_nan && (mini ? fin_v < old : fin_v > old);
  const int best = fin_i;
  for (int j = threadIdx.x; j < v; j += blockDim.x)
    bx_out[r * v + j] =
        better ? x[(r * n + best) * v + j] : bx_in[r * v + j];
  if (threadIdx.x == 0) by_out[r] = better ? fin_v : old;
}

bool bad_global(int replicas, int n, int v, int c) {
  return replicas < 1 || n < 2 || n % 2 || v < 1 || c < 1 || c > 31;
}

unsigned blocks_for(size_t items, int threads) {
  return (unsigned)((items + threads - 1) / threads);
}

bool bad_shape(size_t smem, int n, int v, int c, int p, int steps) {
  return smem > (size_t)kSmemLimit || n < 2 || n % 2 || v < 1 || c < 1 ||
         c > 31 || p < 0 || p > n || steps < 0;
}

// Whether kernel `which` has no build with population words of `bits`
// bits: every kernel has 32; K2 alone has 16, for c <= 16 (which keeps
// every word the GA makes below 2^16; the launch checks c).
bool bad_layout(int which, int bits) {
  return !(bits == 32 || (bits == 16 && which == 1));
}

// Once a kernel and device: the dynamic shared memory limit raised to all a
// block can use, and the carveout set to all shared memory, so two island
// blocks can share an SM.  Setting an attribute twice does no harm, so two
// threads that race to the first launch need no lock.
cudaError_t allow_smem(const void* kernel, int which) {
  static std::atomic<bool> allowed[18][kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<bool>& done = allowed[which][dev];
  if (done.load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e == cudaSuccess) done.store(true, std::memory_order_release);
  return e;
}

using EpochKernel = void (*)(const Stack, const Shape, const Epoch);

// K2's builds: the two-lane form only at 16 bits without data (the
// launchers refuse it elsewhere).
template <int kSteps, bool kData>
EpochKernel epoch_built(int bits, int lanes) {
  if constexpr (!kData)
    if (lanes == 2) return ga_epoch<kSteps, uint16_t, false, 2>;
  return bits == 16 ? ga_epoch<kSteps, uint16_t, kData, 1>
                    : ga_epoch<kSteps, uint32_t, kData, 1>;
}

template <int kSteps, bool kData>
const void* kernel_built(int which, int bits, int lanes) {
  switch (which) {
    case 0: return (const void*)ga_generation<kSteps, kData>;
    case 1: return (const void*)epoch_built<kSteps, kData>(bits, lanes);
    case 2: return (const void*)ga_streamed_epoch<kSteps, kData>;
  }
  return nullptr;
}

// Whether a problem takes the builds with problem data (rastrigin_sr's),
// and whether that build cannot take V: it holds an individual's V values
// in registers, and reads its data through the pointer it is given.
bool has_data(int problem) { return problem == kRastriginSR; }

bool bad_data(int problem, int v, const void* data) {
  return has_data(problem) && (v < 2 || v > kSRMaxVars || data == nullptr);
}

// The build of kernel `which` (0: K1, 1: K2, 2: K3) a shape takes at
// population layout `bits` for `problem`: the paper's clocks a draw as a
// constant (kPaperSteps) where the mutation rows below P stay in shared
// memory, else the run-time form (0).
int form_of(int which, int n, int v, int p, int steps, int bits,
            int problem) {
  p = p < n ? p : n;
  return steps == kPaperSteps &&
                 !rows_in_global(which, n, v, p, bits,
                                 data_words(problem, v))
             ? kPaperSteps
             : 0;
}

// Whether K2 cannot take `lanes` threads a pair: 1 everywhere, 2 only in
// its 16-bit builds without data at 32 <= n <= kMaxThreads, n a multiple of
// 32 (every lane of the block an individual).
bool bad_lanes(int which, int n, int bits, int problem, int lanes) {
  if (lanes == 1) return false;
  return lanes != 2 || which != 1 || bits != 16 || has_data(problem) ||
         n < 32 || n > kMaxThreads || n % 32;
}

// Kernel `which` in build `form` at layout `bits` for `problem` with
// `lanes` threads a pair, and its slot in allow_smem's table (K2's 16-bit
// builds after the six 32-bit ones; rastrigin_sr's eight builds after the
// other eight; K2's two-lane builds last).
const void* kernel_of(int which, int form, int bits, int problem,
                      int lanes) {
  if (has_data(problem))
    return form == kPaperSteps
               ? kernel_built<kPaperSteps, true>(which, bits, lanes)
               : kernel_built<0, true>(which, bits, lanes);
  return form == kPaperSteps
             ? kernel_built<kPaperSteps, false>(which, bits, lanes)
             : kernel_built<0, false>(which, bits, lanes);
}

int slot_of(int which, int form, int bits, int problem, int lanes) {
  if (lanes == 2) return 16 + (form == kPaperSteps);
  return 8 * has_data(problem) + 2 * (bits == 16 ? 3 : which) +
         (form == kPaperSteps);
}

// Bytes a block of kernel `which` takes at layout `bits` for `problem`: its
// data, and the mutation rows below P unless they stay in global memory.
size_t smem_of(int which, int n, int v, int p, int bits, int problem) {
  p = p < n ? p : n;        // rows past N are none
  const int dw = data_words(problem, v);
  return 4 * (base_words(which, n, v, bits, dw) +
              (rows_in_global(which, n, v, p, bits, dw) ? 0
                                                        : (size_t)v * p));
}

// The kernel's Shape; p is taken as min(P, N).
Shape shape_of(int which, int n, int v, int c, int idx_bits, int cut_bits,
               int p, int steps, int minimize, int problem, int bits) {
  p = p < n ? p : n;
  return Shape{n, v, c, idx_bits, cut_bits, p, steps, minimize, problem,
               (int)rows_in_global(which, n, v, p, bits,
                                   data_words(problem, v))};
}

Stack make_stack(const void* x_in, const void* sel_in, const void* cross_in,
                 const void* mut_in, void* x_out, void* sel_out,
                 void* cross_out, void* mut_out, void* y_out, void* best_y,
                 void* best_x, const void* lo, const void* span,
                 const void* data) {
  return Stack{(const uint32_t*)x_in, (const uint32_t*)sel_in,
               (const uint32_t*)cross_in, (const uint32_t*)mut_in,
               (uint32_t*)x_out, (uint32_t*)sel_out, (uint32_t*)cross_out,
               (uint32_t*)mut_out, (float*)y_out, (float*)best_y,
               (uint32_t*)best_x, (const float*)lo, (const float*)span,
               (const float*)data};
}

// A launch configuration of `blocks` blocks of `threads` threads, with a
// cluster of `cluster` blocks when cluster > 0, and cooperative (every
// block co-resident, or the launch is refused) with `cooperative`.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(int blocks, int threads, size_t smem, void* stream, int cluster,
         bool cooperative = false) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    if (cluster > 0) {
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
    } else if (cooperative) {
      attr[0].id = cudaLaunchAttributeCooperative;
      attr[0].val.cooperative = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
    }
  }
};

}  // namespace

extern "C" {

size_t ga_step_smem_bytes(int n, int v, int p) {
  return smem_of(0, n, v, p, 32, kF1);
}

// A K2 block at population layout `bits` (16 or 32); a K3 block is K2's at
// 32 bits.
size_t ga_epoch_smem_bytes(int n, int v, int p, int bits) {
  return smem_of(1, n, v, p, bits, kF1);
}

// A block of kernel `which` (0: K1, 1: K2, 2: K3) at layout `bits` for
// built-in problem `problem`, its data included.
size_t ga_block_smem_bytes(int which, int n, int v, int p, int bits,
                           int problem) {
  return smem_of(which, n, v, p, bits, problem);
}

int ga_step_smem_limit() { return kSmemLimit; }

int ga_step_max_cluster() { return kMaxCluster; }

// Threads of a block at population size n with `lanes` threads a pair.
int ga_step_threads(int n, int lanes) { return threads_for(n, lanes); }

const char* ga_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1: launch `replicas` blocks on `stream`; returns the cudaError_t of the
// launch (0 = queued).  Pointers are device pointers of contiguous buffers.
// `data`: the problem's data (rastrigin_sr: o [V] then M [V, V], float32),
// else null.
int ga_step_launch(const void* x_in, const void* sel_in, const void* cross_in,
                   const void* mut_in, void* x_out, void* sel_out,
                   void* cross_out, void* mut_out, void* y_out, void* best_y,
                   void* best_x, const void* lo, const void* span,
                   const void* data, int replicas, int n, int v, int c,
                   int idx_bits, int cut_bits, int p, int steps, int minimize,
                   int problem, int gens, int track_best, void* stream) {
  const size_t smem = smem_of(0, n, v, p, 32, problem);
  if (bad_shape(smem, n, v, c, p, steps) || bad_data(problem, v, data) ||
      replicas < 1 || gens < 1)
    return (int)cudaErrorInvalidValue;
  const int form = form_of(0, n, v, p, steps, 32, problem);
  const void* kernel = kernel_of(0, form, 32, problem, 1);
  cudaError_t e = allow_smem(kernel, slot_of(0, form, 32, problem, 1));
  if (e != cudaSuccess) return (int)e;
  const Stack g = make_stack(x_in, sel_in, cross_in, mut_in, x_out, sel_out,
                             cross_out, mut_out, y_out, best_y, best_x, lo,
                             span, data);
  const Shape S = shape_of(0, n, v, c, idx_bits, cut_bits, p, steps,
                           minimize, problem, 32);
  auto* step = (void (*)(const Stack, const Shape, int, int))kernel;
  step<<<replicas, threads_for(n, 1), smem, (cudaStream_t)stream>>>(
      g, S, gens, track_best);
  return (int)cudaGetLastError();
}

// K2: `groups` x `islands` blocks at population layout `bits` (16 needs
// c <= 16 and words below 2^16) with `lanes` threads a pair (2: the
// two-lane form, `bad_lanes`); with `migrate`, each group's islands are
// one cluster.  `boundary` needs `migrate` and one interval.
int ga_epoch_launch(const void* x_in, const void* sel_in,
                    const void* cross_in, const void* mut_in, void* x_out,
                    void* sel_out, void* cross_out, void* mut_out,
                    void* y_out, void* best_y, void* best_x,
                    void* send_elite, void* worst0, const void* lo,
                    const void* span, const void* data, int groups,
                    int islands, int n, int v, int c, int idx_bits,
                    int cut_bits, int p, int steps, int minimize, int problem,
                    int migrate_every, int intervals, int migrate,
                    int boundary, int bits, int lanes, void* stream) {
  const size_t smem = smem_of(1, n, v, p, bits, problem);
  if (bad_shape(smem, n, v, c, p, steps) || bad_layout(1, bits) ||
      bad_data(problem, v, data) || (bits == 16 && c > 16) ||
      bad_lanes(1, n, bits, problem, lanes) || groups < 1 ||
      islands < 1 || (migrate && islands > kMaxCluster) ||
      migrate_every < 1 || intervals < 1 ||
      (boundary && (!migrate || intervals != 1)))
    return (int)cudaErrorInvalidValue;
  const int form = form_of(1, n, v, p, steps, bits, problem);
  const void* kernel = kernel_of(1, form, bits, problem, lanes);
  cudaError_t e = allow_smem(kernel, slot_of(1, form, bits, problem, lanes));
  if (e != cudaSuccess) return (int)e;
  const Stack g = make_stack(x_in, sel_in, cross_in, mut_in, x_out, sel_out,
                             cross_out, mut_out, y_out, best_y, best_x, lo,
                             span, data);
  const Shape S = shape_of(1, n, v, c, idx_bits, cut_bits, p, steps,
                           minimize, problem, bits);
  const Epoch E{islands, migrate_every, intervals, migrate, boundary,
                (uint32_t*)send_elite, (int*)worst0};
  Launch L(groups * islands, threads_for(n, lanes), smem, stream,
           migrate ? islands : 0);
  e = cudaLaunchKernelEx(&L.cfg, (EpochKernel)kernel, g, S, E);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `islands` K2 blocks at (n, v, p, steps), population
// layout `bits`, `problem`'s build and `lanes` threads a pair the card
// holds at once (cudaOccupancyMaxActiveClusters), into *out; returns the
// cudaError_t.
int ga_epoch_max_active_clusters(int n, int v, int p, int steps, int islands,
                                 int bits, int problem, int lanes, int* out) {
  if (bad_layout(1, bits) || bad_lanes(1, n, bits, problem, lanes))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_of(1, n, v, p, bits, problem);
  const int form = form_of(1, n, v, p, steps, bits, problem);
  const void* kernel = kernel_of(1, form, bits, problem, lanes);
  cudaError_t e = allow_smem(kernel, slot_of(1, form, bits, problem, lanes));
  if (e != cudaSuccess) return (int)e;
  Launch L(islands, threads_for(n, lanes), smem, nullptr, islands);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &L.cfg);
}

// Kernel `which` (0: K1, 1: K2, 2: K3) as compiled for `steps` clocks a
// draw at population layout `bits` (16: K2 alone) for `problem` (its data
// build for rastrigin_sr) with `lanes` threads a pair (2: K2's two-lane
// form): registers a thread, local (spill and stack) bytes a thread, and
// the blocks an SM holds at (n, v, p)
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int ga_step_kernel_attrs(int which, int n, int v, int p, int steps, int bits,
                         int problem, int lanes, int* regs, int* local_bytes,
                         int* blocks_per_sm) {
  if (bad_layout(which, bits) || bad_lanes(which, n, bits, problem, lanes))
    return (int)cudaErrorInvalidValue;
  const int form = form_of(which, n, v, p, steps, bits, problem);
  const void* kernel = kernel_of(which, form, bits, problem, lanes);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_of(which, n, v, p, bits, problem);
  cudaError_t e =
      allow_smem(kernel, slot_of(which, form, bits, problem, lanes));
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, threads_for(n, lanes), smem);
}

// K3: `groups` x `islands / tile` blocks, each walking `tile` islands for
// `intervals` intervals (1 without `splice`).  With the ring inside
// (`migrate` and `splice`) the launch is cooperative and its groups go in
// waves of `wave_groups`, each a launch whose blocks the card holds at
// once; `arrived` holds one zeroed counter a group.  Without `splice`,
// `elite` and `worst` are the outputs [G, I, V] and [G, I]; with it, the
// exchange buffer [2, G, I, V] and the worst slots [G, I].
int ga_streamed_launch(const void* x_in, const void* sel_in,
                       const void* cross_in, const void* mut_in, void* x_out,
                       void* sel_out, void* cross_out, void* mut_out,
                       void* y_out, void* best_y, void* best_x, void* elite,
                       void* worst, void* arrived, const void* lo,
                       const void* span, const void* data, int groups,
                       int islands, int tile, int n, int v, int c,
                       int idx_bits, int cut_bits, int p, int steps,
                       int minimize, int problem, int migrate_every,
                       int intervals, int migrate, int splice,
                       int wave_groups, void* stream) {
  const size_t smem = smem_of(2, n, v, p, 32, problem);
  if (bad_shape(smem, n, v, c, p, steps) || bad_data(problem, v, data) ||
      groups < 1 || islands < 1 || tile < 1 || islands % tile ||
      migrate_every < 1 || intervals < 1 || (!splice && intervals != 1) ||
      wave_groups < 1)
    return (int)cudaErrorInvalidValue;
  const int form = form_of(2, n, v, p, steps, 32, problem);
  const void* built = kernel_of(2, form, 32, problem, 1);
  cudaError_t e = allow_smem(built, slot_of(2, form, 32, problem, 1));
  if (e != cudaSuccess) return (int)e;
  const Stack g = make_stack(x_in, sel_in, cross_in, mut_in, x_out, sel_out,
                             cross_out, mut_out, y_out, best_y, best_x, lo,
                             span, data);
  const Shape S = shape_of(2, n, v, c, idx_bits, cut_bits, p, steps,
                           minimize, problem, 32);
  const bool ring = migrate && splice;
  const int wave = ring ? wave_groups : groups;
  auto* kernel = (void (*)(const Stack, const Shape, const Streamed))built;
  for (int g0 = 0; g0 < groups; g0 += wave) {
    const int count = groups - g0 < wave ? groups - g0 : wave;
    const Streamed T{groups, islands, tile, migrate_every, intervals,
                     migrate, splice, g0, (uint32_t*)elite, (int*)worst,
                     (unsigned*)arrived};
    Launch L(count * (islands / tile), threads_for(n, 1), smem, stream, 0,
             ring);
    e = cudaLaunchKernelEx(&L.cfg, kernel, g, S, T);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// How many K3 blocks at (n, v, p, steps) in `problem`'s build the card
// holds at once: the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the SMs, into
// *out; returns the cudaError_t.
int ga_streamed_capacity(int n, int v, int p, int steps, int problem,
                         int* out) {
  const size_t smem = smem_of(2, n, v, p, 32, problem);
  const int form = form_of(2, n, v, p, steps, 32, problem);
  const void* kernel = kernel_of(2, form, 32, problem, 1);
  cudaError_t e = allow_smem(kernel, slot_of(2, form, 32, problem, 1));
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads_for(n, 1), smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * sms;
  return 0;
}

// The global form of K1, one generation's three kernels (see above); each
// returns the cudaError_t of its launch.  ga_ffm: y [R, N] of x [R, N, V]
// for built-in problem `problem`, tiles of `tile` rows: with `spread` the
// spread form (sphere to ackley; tile a power of two <= 256, chunks of
// `chunk` variables), else the rows form (tile 256, 512 or 1024, chunk =
// v); the block's shared memory within kFfmSmemLimit.
int ga_ffm_launch(const void* x, void* y, const void* lo, const void* span,
                  int replicas, int n, int v, int c, int problem, int tile,
                  int chunk, int spread, void* stream) {
  const size_t smem = ffm_tile_bytes(tile, chunk, spread != 0);
  if (bad_global(replicas, n, v, c) || problem < kF1 || problem > kAckley ||
      tile < 1 || (tile & (tile - 1)) || chunk < 1 || chunk > v ||
      smem > (size_t)kFfmSmemLimit ||
      (spread && (problem < kSphere || tile > kGlobalThreads)) ||
      (!spread && (chunk != v || tile < kGlobalThreads ||
                   tile > 4 * kGlobalThreads)))
    return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)replicas * n;
  const uint32_t* xw = (const uint32_t*)x;
  const float *l = (const float*)lo, *sp = (const float*)span;
  float* out = (float*)y;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (spread) {
    switch (problem) {
      case kSphere:
        e = ffm_run<0, kSphere>(xw, out, l, sp, rows, v, c, problem, tile,
                                chunk, smem, s);
        break;
      case kRastrigin:
        e = ffm_run<0, kRastrigin>(xw, out, l, sp, rows, v, c, problem,
                                   tile, chunk, smem, s);
        break;
      case kRosenbrock:
        e = ffm_run<0, kRosenbrock>(xw, out, l, sp, rows, v, c, problem,
                                    tile, chunk, smem, s);
        break;
      default:
        e = ffm_run<0, kAckley>(xw, out, l, sp, rows, v, c, problem, tile,
                                chunk, smem, s);
    }
  } else if (tile == kGlobalThreads) {
    e = ffm_run<1, 0>(xw, out, l, sp, rows, v, c, problem, tile, chunk,
                      smem, s);
  } else if (tile == 2 * kGlobalThreads) {
    e = ffm_run<2, 0>(xw, out, l, sp, rows, v, c, problem, tile, chunk,
                      smem, s);
  } else {
    e = ffm_run<4, 0>(xw, out, l, sp, rows, v, c, problem, tile, chunk,
                      smem, s);
  }
  return (int)e;
}

// ga_ffm for rastrigin_sr: its rows form at one row a thread (tiles of
// kGlobalThreads rows, chunk = v), the problem's `data` (o [V] then M [V,
// V], float32) first in the block; V at most kSRMaxVars.
int ga_ffm_data_launch(const void* x, void* y, const void* lo,
                       const void* span, const void* data, int replicas,
                       int n, int v, int c, int problem, void* stream) {
  const size_t smem = ffm_tile_bytes(kGlobalThreads, v, false) +
                      4 * (size_t)data_words(problem, v);
  if (bad_global(replicas, n, v, c) || problem != kRastriginSR ||
      bad_data(problem, v, data) || smem > (size_t)kFfmSmemLimit)
    return (int)cudaErrorInvalidValue;
  return (int)ffm_run<1, kRastriginSR>(
      (const uint32_t*)x, (float*)y, (const float*)lo, (const float*)span,
      (size_t)replicas * n, v, c, problem, kGlobalThreads, v, smem,
      (cudaStream_t)stream, (const float*)data);
}

// ga_operators: the offspring and the clocked banks of one generation, a
// block a tile of `tile` pairs (a power of two dividing N/2) and `chunk`
// variables (see the note above).  The banks are read and written as
// 8-byte words, so their pointers must be 8-byte aligned.
int ga_operators_launch(const void* x, const void* y, const void* sel,
                        const void* cross, const void* mut, void* x_out,
                        void* sel_out, void* cross_out, void* mut_out,
                        int replicas, int n, int v, int c, int idx_bits,
                        int cut_bits, int p, int steps, int minimize,
                        int tile, int chunk, void* stream) {
  if (bad_global(replicas, n, v, c) || (n & (n - 1)) || idx_bits < 1 ||
      idx_bits > 31 || (1u << idx_bits) != (unsigned)n || cut_bits < 1 ||
      cut_bits > 31 || p < 0 || p > n || steps < 0 || tile < 1 ||
      (tile & (tile - 1)) || (n / 2) % tile || chunk < 1 || chunk > v ||
      4 * ops_tile_words(tile, chunk) > (size_t)kOpsSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)sel | (uintptr_t)mut | (uintptr_t)sel_out |
       (uintptr_t)mut_out) & 7)
    return (int)cudaErrorMisalignedAddress;
  const Operators O{(const uint32_t*)x,     (const float*)y,
                    (const uint32_t*)sel,   (const uint32_t*)cross,
                    (const uint32_t*)mut,   (uint32_t*)x_out,
                    (uint32_t*)sel_out,     (uint32_t*)cross_out,
                    (uint32_t*)mut_out};
  const Shape S{n, v, c, idx_bits, cut_bits, p, steps, minimize, -1, 0};
  const dim3 grid((unsigned)((size_t)replicas * (n / 2 / tile)),
                  (unsigned)((v + chunk - 1) / chunk));
  ga_operators<<<grid, kGlobalThreads, 4 * ops_tile_words(tile, chunk),
                 (cudaStream_t)stream>>>(O, S, tile, chunk);
  return (int)cudaGetLastError();
}

// ga_best: (best_y, best_x) folded with the best of (x, y), a cluster of
// `blocks` blocks a replica, block k folding y[k * slice, (k + 1) * slice)
// of its row (every block some of it).
int ga_best_launch(const void* x, const void* y, const void* best_y_in,
                   const void* best_x_in, void* best_y_out, void* best_x_out,
                   int replicas, int n, int v, int minimize, int blocks,
                   int slice, void* stream) {
  if (bad_global(replicas, n, v, 1) || blocks < 1 || blocks > kMaxCluster ||
      slice < 1 || (long long)blocks * slice < n ||
      (long long)(blocks - 1) * slice >= n)
    return (int)cudaErrorInvalidValue;
  Launch L(replicas * blocks, kBestThreads, 0, stream, blocks);
  const cudaError_t e = cudaLaunchKernelEx(
      &L.cfg, ga_best, (const uint32_t*)x, (const float*)y,
      (const float*)best_y_in, (const uint32_t*)best_x_in,
      (float*)best_y_out, (uint32_t*)best_x_out, n, v, slice, minimize);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Registers and local (spill and stack) bytes a thread of the global
// form's kernel `which`: 0 ga_ffm's spread form for rastrigin, 1
// ga_operators, 2 ga_best, 3, 4, 5 ga_ffm's rows form at K = 1, 2, 4, 6,
// 7, 8 its spread form for sphere, rosenbrock, ackley, 9 its rows form for
// rastrigin_sr.
int ga_global_kernel_attrs(int which, int* regs, int* local_bytes) {
  const void* kernel = which == 0   ? (const void*)ga_ffm<0, kRastrigin>
                       : which == 1 ? (const void*)ga_operators
                       : which == 2 ? (const void*)ga_best
                       : which == 3 ? (const void*)ga_ffm<1, 0>
                       : which == 4 ? (const void*)ga_ffm<2, 0>
                       : which == 5 ? (const void*)ga_ffm<4, 0>
                       : which == 6 ? (const void*)ga_ffm<0, kSphere>
                       : which == 7 ? (const void*)ga_ffm<0, kRosenbrock>
                       : which == 8 ? (const void*)ga_ffm<0, kAckley>
                       : which == 9 ? (const void*)ga_ffm<1, kRastriginSR>
                                    : nullptr;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
