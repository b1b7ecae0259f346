// Step marks: empty kernels that name the phases of a training step in a
// device trace (utils/profiling.py `step_phase`).
//
// A step that runs as a CUDA graph runs no Python at a replay, so no
// profiler range opened in the step exists then. Launched while the step's
// stream is captured, a mark becomes a node of the graph: every replay runs
// it in stream order between the kernels of the phase before it and those
// of the phase after it. A trace then splits a replay's device time by
// phase from the marks' own times.
//
// One kernel a phase and edge, named `ofb_mark_<phase>_<begin|end>` in
// plain text (extern "C": no mangling), so that a reader of a trace needs
// no table from the program. A mark is one block of one thread with no
// arguments; it reads and writes nothing.
#include <cuda_runtime.h>

// the phases in the order of utils/profiling.py PHASES
#define OFB_PHASES(X) X(input) X(forward) X(loss) X(backward) X(update)

#define OFB_MARK_KERNELS(p)                            \
  extern "C" __global__ void ofb_mark_##p##_begin() {} \
  extern "C" __global__ void ofb_mark_##p##_end() {}
OFB_PHASES(OFB_MARK_KERNELS)

namespace {

#define OFB_MARK_PAIR(p)                                      \
  {reinterpret_cast<const void*>(&ofb_mark_##p##_begin),      \
   reinterpret_cast<const void*>(&ofb_mark_##p##_end)},
const void* const kMarks[][2] = {OFB_PHASES(OFB_MARK_PAIR)};
constexpr int kPhases = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

// Loads every mark kernel into the current context (with lazy module
// loading a kernel is otherwise loaded at its first launch), so that a
// capture only records launches. Returns 0 or the first CUDA error.
extern "C" int ofb_step_marks_load() {
  for (int p = 0; p < kPhases; ++p) {
    for (int e = 0; e < 2; ++e) {
      cudaFuncAttributes attr;
      cudaError_t rc = cudaFuncGetAttributes(&attr, kMarks[p][e]);
      if (rc != cudaSuccess) return rc;
    }
  }
  return 0;
}

// Launches the mark of `phase` (an index into OFB_PHASES) at `edge` (0:
// begin, 1: end) on `stream`. Returns -1 for an index out of range, else
// cudaGetLastError() after the launch.
extern "C" int ofb_step_mark(int phase, int edge, void* stream) {
  if (phase < 0 || phase >= kPhases || edge < 0 || edge > 1) return -1;
  cudaLaunchKernel(kMarks[phase][edge], dim3(1), dim3(1), nullptr, 0,
                   static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}
