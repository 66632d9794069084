// lfsr_advance.cu — bulk LFSR-32 advance on Hopper (sm_90a): K4.
//
// Replaces src/repro/kernels/lfsr_kernel.py::lfsr_advance_kernel, the Pallas
// TPU kernel of the JAX package: every uint32 lane of an array of any shape
// is clocked `steps` times by the paper's polynomial r^32 + r^22 + r^2 + 1
// (feedback s31 ^ s21 ^ s1 ^ s0 into bit 0, the register shifting left).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void lfsr_advance(const uint32_t* in, uint32_t* out, size_t n,
                             int steps) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t s = in[i];
    for (int t = 0; t < steps; ++t) {
      uint32_t fb = ((s >> 31) ^ (s >> 21) ^ (s >> 1) ^ s) & 1u;
      s = (s << 1) | fb;
    }
    out[i] = s;
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

}  // extern "C"
