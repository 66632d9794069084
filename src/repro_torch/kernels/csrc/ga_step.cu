// ga_step.cu — fused GA generations on Hopper (sm_90a), one thread block per
// replica.
//
// Replaces src/repro/kernels/ga_step.py::ga_generation_kernel, the Pallas TPU
// kernel of the JAX package.  Per replica it runs `gens` generations of the
// paper's datapath: a clock of the three LFSR banks (selection, crossover,
// mutation) by `steps` bits, the FFM stage (decode + the problem's float32
// expression), 2-way tournaments on the top `idx_bits` of the selection
// draws, mask-shift single-point crossover with per-variable cut points, and
// an XOR mutation of the first P rows.  With `track_best` it folds the
// running best individual over the in-kernel generations with strict
// improvement and the first-occurrence tie rule of the reference scan.
//
// What bounds it.  At the real-size shape (N=1024, V=8, 128 replicas, 64
// generations a launch) the state of one replica is N*V + 2N + V*N/2 + V*N =
// 22,528 words (88 KiB), 11 MiB for the stack, so HBM traffic is 2 x 11 MiB
// = 23.6 MB per launch: 7 us at 3.35 TB/s.  The work is integer and float32
// issue: every generation advances the 14,336 words of the three LFSR banks
// (the population is not clocked) by 3 clocks, evaluates N fitness values
// (decode plus ~7 float ops, one a cosine, per variable for rastrigin), and
// runs N tournaments and N*V/2 crossovers.  Counting the LFSR advance as a
// GF(2) leap of 5 word ops a clock (parity of the word under each feedback
// mask), the least the work needs is ~0.35 M operations per replica and
// generation: 2.84 G a launch, 42 us at the card's 67 T/s non-tensor
// float32 rate (the count chip_smoke.py makes).  The kernel is
// operation-bound by a factor of six, and more so the more generations a
// launch folds.  It clocks the banks one bit at a time (9 ops a clock), the
// simple form; the leap is a later optimisation.
//
// What the design does about it.  The whole GA state of a replica (the
// population, the offspring buffer, the fitness vector and the three LFSR
// banks) lives in dynamic shared memory for all `gens` generations: HBM sees
// one state read and one write per launch, and every gather of the
// tournament is one shared-memory read (the TPU kernel's one-hot MXU lane
// has no purpose here).  One block per replica needs no inter-block
// communication; the stack of replicas fills the SMs.  Shared memory bounds
// the shape: 4 * (N * (3.5 V + 3) + 3 V + 66) bytes must fit the 227 KB a
// block can use; the Python wrapper checks this before launching.
//
// Numerics.  Built with -fmad=false and the default IEEE division and
// square root, so each float operation rounds once, in the order the plain
// PyTorch version (repro_torch/core/fitness.py) evaluates it: cubes as
// x*(x*x), sums over V left to right.  Integer work is exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;   // 227 KB of dynamic shared memory a block

enum Problem { kF1 = 0, kF2, kF3, kSphere, kRastrigin, kRosenbrock, kAckley };

struct Params {
  const uint32_t* x_in;      // [R, N, V]
  const uint32_t* sel_in;    // [R, 2, N]
  const uint32_t* cross_in;  // [R, V, N/2]
  const uint32_t* mut_in;    // [R, V, N]
  uint32_t* x_out;
  uint32_t* sel_out;
  uint32_t* cross_out;
  uint32_t* mut_out;
  float* y_out;              // [R, N]   fitness of the last pre-update population
  float* best_y;             // [R]      (track_best)
  uint32_t* best_x;          // [R, V]   (track_best)
  const float* lo;           // [V] decode offsets
  const float* span;         // [V] decode steps
  int n, v, c, idx_bits, cut_bits, p, steps, minimize, problem, gens,
      track_best;
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

__global__ void __launch_bounds__(kMaxThreads)
ga_generation(const Params P) {
  extern __shared__ uint32_t smem[];
  const int n = P.n, v = P.v, half = n / 2;
  const int r = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const bool minimize = P.minimize != 0;

  uint32_t* sx = smem;                         // [N, V]
  uint32_t* sw = sx + (size_t)n * v;           // [N, V] tournament winners
  float* sy = (float*)(sw + (size_t)n * v);    // [N]
  uint32_t* ssel = (uint32_t*)(sy + n);        // [2, N]
  uint32_t* scross = ssel + 2 * n;             // [V, N/2]
  uint32_t* smut = scross + (size_t)v * half;  // [V, N]
  float* slo = (float*)(smut + (size_t)v * n); // [V]
  float* sspan = slo + v;                      // [V]
  uint32_t* sbx = (uint32_t*)(sspan + v);      // [V]
  float* sby = (float*)(sbx + v);              // [1]
  float* rval = sby + 2;                       // [32]
  int* ridx = (int*)(rval + 32);               // [32]

  const size_t ox = (size_t)r * n * v, osel = (size_t)r * 2 * n,
               ocross = (size_t)r * v * half, omut = (size_t)r * v * n;
  for (int i = tid; i < n * v; i += nt) sx[i] = P.x_in[ox + i];
  for (int i = tid; i < 2 * n; i += nt) ssel[i] = P.sel_in[osel + i];
  for (int i = tid; i < v * half; i += nt) scross[i] = P.cross_in[ocross + i];
  for (int i = tid; i < v * n; i += nt) smut[i] = P.mut_in[omut + i];
  for (int j = tid; j < v; j += nt) {
    slo[j] = P.lo[j];
    sspan[j] = P.span[j];
    sbx[j] = 0u;
  }
  if (tid == 0) *sby = minimize ? INFINITY : -INFINITY;
  __syncthreads();

  const uint32_t mask = (1u << P.c) - 1u;
  const int sel_shift = 32 - P.idx_bits, cut_shift = 32 - P.cut_bits,
            mut_shift = 32 - P.c;

  for (int g = 0; g < P.gens; ++g) {
    // ---- RNG: clock all three banks ------------------------------------
    for (int i = tid; i < 2 * n; i += nt) ssel[i] = lfsr_clock(ssel[i], P.steps);
    for (int i = tid; i < v * half; i += nt)
      scross[i] = lfsr_clock(scross[i], P.steps);
    for (int i = tid; i < v * n; i += nt) smut[i] = lfsr_clock(smut[i], P.steps);

    // ---- FFM ------------------------------------------------------------
    for (int i = tid; i < n; i += nt) {
      Decoder d{sx + (size_t)i * v, mask, slo, sspan};
      sy[i] = ffm(P.problem, d, v);
    }
    __syncthreads();

    // ---- running best of the pre-update population (thread 0 only) ------
    if (P.track_best) {
      int b = block_best(sy, n, minimize, rval, ridx);
      if (tid == 0) {
        float gb = sy[b];
        if (minimize ? gb < *sby : gb > *sby) {
          *sby = gb;
          for (int j = 0; j < v; ++j) sbx[j] = sx[(size_t)b * v + j];
        }
      }
    }

    // ---- SM: 2-way tournaments, one shared-memory read per contestant ---
    for (int i = tid; i < n; i += nt) {
      int i1 = (int)(ssel[i] >> sel_shift);
      int i2 = (int)(ssel[n + i] >> sel_shift);
      float y1 = sy[i1], y2 = sy[i2];
      bool first = minimize ? (y1 <= y2) : (y1 >= y2);
      const uint32_t* src = sx + (size_t)(first ? i1 : i2) * v;
      for (int j = 0; j < v; ++j) sw[(size_t)i * v + j] = src[j];
    }
    __syncthreads();

    // ---- CM + MM: per pair and variable, crossover then XOR mutation ----
    for (int q = tid; q < half * v; q += nt) {
      int pr = q / v, j = q - pr * v;
      int a = 2 * pr, b = a + 1;
      uint32_t cut = scross[(size_t)j * half + pr] >> cut_shift;
      cut = cut < (uint32_t)P.c ? cut : (uint32_t)P.c;
      uint32_t s = mask >> cut;
      uint32_t w1 = sw[(size_t)a * v + j], w2 = sw[(size_t)b * v + j];
      uint32_t z1 = (w1 & ~s) | (w2 & s);
      uint32_t z2 = (w2 & ~s) | (w1 & s);
      if (a < P.p) z1 ^= smut[(size_t)j * n + a] >> mut_shift;
      if (b < P.p) z2 ^= smut[(size_t)j * n + b] >> mut_shift;
      sx[(size_t)a * v + j] = z1;
      sx[(size_t)b * v + j] = z2;
    }
    __syncthreads();
  }

  for (int i = tid; i < n * v; i += nt) P.x_out[ox + i] = sx[i];
  for (int i = tid; i < 2 * n; i += nt) P.sel_out[osel + i] = ssel[i];
  for (int i = tid; i < v * half; i += nt) P.cross_out[ocross + i] = scross[i];
  for (int i = tid; i < v * n; i += nt) P.mut_out[omut + i] = smut[i];
  for (int i = tid; i < n; i += nt) P.y_out[(size_t)r * n + i] = sy[i];
  if (P.track_best) {
    for (int j = tid; j < v; j += nt) P.best_x[(size_t)r * v + j] = sbx[j];
    if (tid == 0) P.best_y[r] = *sby;
  }
}

}  // namespace

extern "C" {

size_t ga_step_smem_bytes(int n, int v) { return 4 * smem_words(n, v); }

int ga_step_smem_limit() { return kSmemLimit; }

const char* ga_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch `replicas` blocks on `stream`; returns the cudaError_t of the
// launch (0 = queued).  Pointers are device pointers of contiguous buffers.
int ga_step_launch(const void* x_in, const void* sel_in, const void* cross_in,
                   const void* mut_in, void* x_out, void* sel_out,
                   void* cross_out, void* mut_out, void* y_out, void* best_y,
                   void* best_x, const void* lo, const void* span,
                   int replicas, int n, int v, int c, int idx_bits,
                   int cut_bits, int p, int steps, int minimize, int problem,
                   int gens, int track_best, void* stream) {
  size_t smem = 4 * smem_words(n, v);
  if (smem > (size_t)kSmemLimit || replicas < 1 || n < 2 || v < 1 || c < 1 ||
      c > 31)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ga_generation, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  Params P{(const uint32_t*)x_in, (const uint32_t*)sel_in,
           (const uint32_t*)cross_in, (const uint32_t*)mut_in,
           (uint32_t*)x_out, (uint32_t*)sel_out, (uint32_t*)cross_out,
           (uint32_t*)mut_out, (float*)y_out, (float*)best_y,
           (uint32_t*)best_x, (const float*)lo, (const float*)span,
           n, v, c, idx_bits, cut_bits, p, steps, minimize, problem, gens,
           track_best};
  int threads = n < 32 ? 32 : (n > kMaxThreads ? kMaxThreads : n);
  ga_generation<<<replicas, threads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
