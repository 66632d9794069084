// lfsr_advance.cu — the LFSR-32 kernels on Hopper (sm_90a): K4 and the
// initial state's seed words.
//
// K4 replaces src/repro/kernels/lfsr_kernel.py::lfsr_advance_kernel, the
// Pallas TPU kernel of the JAX package: every uint32 lane of an array of any
// shape is clocked `steps` times by the paper's polynomial
// r^32 + r^22 + r^2 + 1 (feedback s31 ^ s21 ^ s1 ^ s0 into bit 0, the
// register shifting left).
//
// What bounds it.  Each word is read once and written once: 8 bytes against
// 9 integer operations a clock in the bit-serial form here (5 in a GF(2)
// leap, the count chip_smoke.py makes).  At the card's 3.35 TB/s and 67 T/s
// the two meet near 5 clocks a word: a few clocks are bytes-bound, tens of
// clocks operation-bound.
//
// What the design does about it.  The TPU kernel pads the array to (8, 128)
// tiles; here one thread takes one word at a time in a grid-stride loop, so
// neighbouring threads read neighbouring words (coalesced), any length runs
// without padding, and the clock loop keeps the word in a register.
//
// seed_state replaces no TPU kernel: the JAX package derives the seed words
// with NumPy on the host (core/lfsr.py np_seeds, core/ga.py init_state), and
// this is the port's form of the same function on the card.  For replica r
// it writes word j of the splitmix stream seeded bases[r] (np_seeds' word j,
// index j + 1) straight into the bank that owns j, in init_states' layout:
// sel [R, 2, N], cross [R, V, N/2], mut [R, V, N], then the last V*N words
// clocked 8 times and truncated to their top c bits into x [R, N, V]; and
// it zeroes k [R].  It reads R seeds and writes 4 bytes a word (a whole
// D=100 stack, 52.6 M words, is 62.9 us of writes at 3.35 TB/s), but the
// splitmix's two 64-bit products make it bound by the instruction rate:
// about 220 G words/s measured on an H100, some 4x the byte bound.  It runs once a stack, off
// every generation's path.  One thread a word, consecutive threads on
// consecutive words of a bank, so every store is coalesced; nothing is
// staged in an [R, total] buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// `steps` clocks of the paper's polynomial, the word kept in a register.
__device__ __forceinline__ uint32_t clock_lfsr(uint32_t s, int steps) {
  for (int t = 0; t < steps; ++t) {
    uint32_t fb = ((s >> 31) ^ (s >> 21) ^ (s >> 1) ^ s) & 1u;
    s = (s << 1) | fb;
  }
  return s;
}

__global__ void lfsr_advance(const uint32_t* in, uint32_t* out, size_t n,
                             int steps) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = clock_lfsr(in[i], steps);
  }
}

// np_seeds' word `j` (0-based) of the stream seeded `base` (< 2^32), in
// wrapping 64-bit arithmetic; an LFSR must not hold 0.
__device__ __forceinline__ uint32_t seed_word(uint64_t base, uint64_t j) {
  uint64_t z = (j + 1 + base * 0x9E3779B9ull) * 0xBF58476D1CE4E5B9ull;
  z ^= z >> 31;
  z *= 0x94D049BB133111EBull;
  z ^= z >> 27;
  const uint32_t w = (uint32_t)z;
  return w ? w : 0xDEADBEEFu;
}

constexpr int kWarmupClocks = 8;

// Thread (blockIdx.x, threadIdx.x) takes word j of each replica
// blockIdx.y, blockIdx.y + gridDim.y, ...
__global__ void seed_state(const uint64_t* bases, int replicas, long long n,
                           long long v, int c, uint32_t* x, uint32_t* sel,
                           uint32_t* cross, uint32_t* mut, int* k) {
  const long long sel_n = 2 * n, cross_n = v * (n / 2), mut_n = v * n;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= sel_n + cross_n + 2 * mut_n) return;
  for (int r = blockIdx.y; r < replicas; r += gridDim.y) {
    const uint32_t w = seed_word(bases[r], (uint64_t)j);
    long long i = j;
    if (i < sel_n) {
      sel[r * sel_n + i] = w;
    } else if ((i -= sel_n) < cross_n) {
      cross[r * cross_n + i] = w;
    } else if ((i -= cross_n) < mut_n) {
      mut[r * mut_n + i] = w;
    } else {
      const uint32_t s = clock_lfsr(w, kWarmupClocks);
      x[r * mut_n + i - mut_n] = c >= 32 ? s : s >> (32 - c);
    }
    if (j == 0) k[r] = 0;
  }
}

}  // namespace

extern "C" {

const char* lfsr_advance_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The kernel as compiled: registers and local bytes a thread
// (cudaFuncGetAttributes), and the blocks of kThreads an SM holds.
int lfsr_advance_attrs(int* regs, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, (const void*)lfsr_advance);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lfsr_advance, kThreads, 0);
}

// Advance `n` words of `in` into `out` (device pointers, contiguous) on
// `stream`; returns the cudaError_t of the launch (0 = queued).
int lfsr_advance_launch(const void* in, void* out, long long n, int steps,
                        void* stream) {
  if (n < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  const int threads = kThreads;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride past ~8 waves
  lfsr_advance<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (size_t)n, steps);
  return (int)cudaGetLastError();
}

// The initial state of `replicas` replicas of N = `n`, V = `v`, c = `c`
// (1..32) from their seeds `bases` (device, uint64 a replica, each < 2^32)
// into x, sel, cross, mut and k (device, contiguous int32) on `stream`;
// returns the cudaError_t of the launch (0 = queued).
int seed_state_launch(const void* bases, int replicas, long long n,
                      long long v, int c, void* x, void* sel, void* cross,
                      void* mut, void* k, void* stream) {
  if (replicas < 1 || n < 2 || v < 1 || c < 1 || c > 32)
    return (int)cudaErrorInvalidValue;
  const long long total = 2 * n + v * (n / 2) + 2 * v * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks,
                  (unsigned)(replicas < 65535 ? replicas : 65535));
  seed_state<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)bases, replicas, n, v, c, (uint32_t*)x,
      (uint32_t*)sel, (uint32_t*)cross, (uint32_t*)mut, (int*)k);
  return (int)cudaGetLastError();
}

}  // extern "C"
