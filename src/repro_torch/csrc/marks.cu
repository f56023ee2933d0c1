// Phase marks of the train step: one empty kernel per phase boundary.
//
// Replaces nothing of src/repro/: the reference's phases show in its XLA
// profile by op name, which a CUDA graph's kernels do not carry. The
// train steps (repro_torch/dist/step.py) launch a mark before the forward,
// the backward, the consensus, the optimizer and the state write, and one
// after the last write (repro_torch.kernels.marks.mark). The step is
// captured from one stream, so its graph is a chain and the marks replay
// in order every step, on the device's clock, beside every other kernel
// of a profiler's trace. A phase lasts from its mark's start to the next
// mark's start (bench/phases.py).
//
// extern "C" keeps the kernels' names unmangled in the trace. Each is
// <<<1, 1>>> on the caller's stream and does nothing: a launch of a node
// in a replayed graph, some microseconds a step.
#include <cuda_runtime.h>

extern "C" __global__ void repro_mark_forward() {}
extern "C" __global__ void repro_mark_backward() {}
extern "C" __global__ void repro_mark_consensus() {}
extern "C" __global__ void repro_mark_optimizer() {}
extern "C" __global__ void repro_mark_state_write() {}
extern "C" __global__ void repro_mark_step_end() {}

// phase: the index of its name in repro_torch.kernels.marks.PHASES
extern "C" int repro_mark(int phase, cudaStream_t stream) {
  switch (phase) {
    case 0: repro_mark_forward<<<1, 1, 0, stream>>>(); break;
    case 1: repro_mark_backward<<<1, 1, 0, stream>>>(); break;
    case 2: repro_mark_consensus<<<1, 1, 0, stream>>>(); break;
    case 3: repro_mark_optimizer<<<1, 1, 0, stream>>>(); break;
    case 4: repro_mark_state_write<<<1, 1, 0, stream>>>(); break;
    case 5: repro_mark_step_end<<<1, 1, 0, stream>>>(); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
