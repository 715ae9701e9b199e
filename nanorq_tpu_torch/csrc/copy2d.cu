// A pitched host-to-device copy: a column range of a pinned host matrix
// crosses to the card in one DMA transfer, with no host staging copy.
//
// The encode's payload matrix lies in pinned memory as [K, Z*T]; a lane (a
// width slice) owns a column range of it, whose rows are `width` bytes every
// `spitch` bytes.  cudaMemcpy2DAsync hands the copy engine that pitched
// source as it is, so the slice is read straight out of the object.  The
// copy is bound by the host link (PCIe), not by the card: no kernel, no
// thread of the card touches it.  Replaces no TPU kernel: JAX places a
// column shard with device_put of the host array's slice.

#include <cstdint>
#include <cuda_runtime.h>

// dst: device, rows of `width` bytes every `dpitch` bytes; src: pinned host,
// rows every `spitch` bytes.  Enqueued on `stream`; returns the CUDA error.
extern "C" int nrq_copy2d(void* dst, int64_t dpitch, const void* src, int64_t spitch, int64_t width,
                          int64_t rows, void* stream) {
  return static_cast<int>(cudaMemcpy2DAsync(dst, static_cast<size_t>(dpitch), src,
                                            static_cast<size_t>(spitch), static_cast<size_t>(width),
                                            static_cast<size_t>(rows), cudaMemcpyHostToDevice,
                                            static_cast<cudaStream_t>(stream)));
}
