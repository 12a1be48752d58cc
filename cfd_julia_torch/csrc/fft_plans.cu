// cuFFT plans on the port's own layouts: a thin C ABI over cuFFT's host
// API, bound with ctypes by cfd_julia_torch/ops/fft_plans.py.
//
// Replaces no Pallas kernel and holds no kernel of its own.  The half-
// spectrum vortex step's inverse transforms (cfd_julia_tpu/models/
// vortex.py:392 make_spectral_step_half, ps23 :457-469, ps32 :470-500; XLA's
// FFTs there) run through torch.fft in the port's twin route, which pads,
// transposes and clones around every inverse (PyTorch clones each c2r
// input, as cuFFT's c2r may overwrite it).  Here the port creates cuFFT
// plans on the layout the derivative pass (csrc/vortex_stage.cu, kernel 9)
// writes: an in-place C2C along kx over the spectra's band columns and an
// out-of-place C2R along ky with the spectra's field-and-row stride, so no
// copy lies between kernel 9 and the product (kernel 10).
//
// A plan is one 1-D transform of length n over `batch` sequences, element k
// of sequence b at b idist + k istride in, b odist + k ostride out (cuFFT's
// advanced layout, cufftMakePlanMany).  Kinds: 0 C2C fp32, 1 C2R fp32, 2 Z2Z
// fp64, 3 Z2D fp64; the C2C runs CUFFT_INVERSE, unnormalised (torch.fft's
// norm="forward" inverse).  The library's own work-area allocation is off:
// the caller allocates the work area (a PyTorch tensor that lives as long as
// the plan) and sets it, so a CUDA graph replay touches only PyTorch's
// memory.  Every function returns cuFFT's cufftResult (0 on success) and
// raises nothing; an execution runs on the caller's stream (cufftSetStream
// at each call) and does not synchronise.

#include <cufft.h>

namespace {

enum Kind { kC2C = 0, kC2R = 1, kZ2Z = 2, kZ2D = 3 };

bool valid_kind(int kind) { return kind >= kC2C && kind <= kZ2D; }

cufftType type_of(int kind) {
  switch (kind) {
    case kC2C: return CUFFT_C2C;
    case kC2R: return CUFFT_C2R;
    case kZ2Z: return CUFFT_Z2Z;
    default: return CUFFT_Z2D;
  }
}

}  // namespace

// a plan of `kind` on the layout; *handle and *work_bytes (the work area the
// caller must set before the first execution) on success
extern "C" int fft_plan_create(int kind, int n, int batch, int istride,
                               int idist, int ostride, int odist,
                               int* handle, long long* work_bytes) {
  if (!valid_kind(kind) || n <= 0 || batch <= 0 || istride <= 0 ||
      ostride <= 0 || idist <= 0 || odist <= 0)
    return CUFFT_INVALID_VALUE;
  cufftHandle plan;
  cufftResult r = cufftCreate(&plan);
  if (r != CUFFT_SUCCESS) return r;
  r = cufftSetAutoAllocation(plan, 0);
  // rank 1: the embeddings' one entry is ignored, but non-null selects the
  // advanced layout (the strides and distances)
  const bool c2r = kind == kC2R || kind == kZ2D;
  int dims[1] = {n};
  int inembed[1] = {c2r ? n / 2 + 1 : n};
  int onembed[1] = {n};
  size_t work = 0;
  if (r == CUFFT_SUCCESS)
    r = cufftMakePlanMany(plan, 1, dims, inembed, istride, idist, onembed,
                          ostride, odist, type_of(kind), batch, &work);
  if (r != CUFFT_SUCCESS) {
    cufftDestroy(plan);
    return r;
  }
  *handle = plan;
  *work_bytes = static_cast<long long>(work);
  return CUFFT_SUCCESS;
}

extern "C" int fft_plan_set_work_area(int handle, void* work) {
  return cufftSetWorkArea(handle, work);
}

// out <- the plan's transform of in (in == out: in place) on `stream`
extern "C" int fft_plan_exec(int handle, int kind, void* in, void* out,
                             void* stream) {
  if (!valid_kind(kind)) return CUFFT_INVALID_VALUE;
  cufftResult r = cufftSetStream(handle, static_cast<cudaStream_t>(stream));
  if (r != CUFFT_SUCCESS) return r;
  switch (kind) {
    case kC2C:
      return cufftExecC2C(handle, static_cast<cufftComplex*>(in),
                          static_cast<cufftComplex*>(out), CUFFT_INVERSE);
    case kC2R:
      return cufftExecC2R(handle, static_cast<cufftComplex*>(in),
                          static_cast<cufftReal*>(out));
    case kZ2Z:
      return cufftExecZ2Z(handle, static_cast<cufftDoubleComplex*>(in),
                          static_cast<cufftDoubleComplex*>(out),
                          CUFFT_INVERSE);
    default:
      return cufftExecZ2D(handle, static_cast<cufftDoubleComplex*>(in),
                          static_cast<cufftDoubleReal*>(out));
  }
}

extern "C" int fft_plan_destroy(int handle) { return cufftDestroy(handle); }

extern "C" int fft_version(int* version) { return cufftGetVersion(version); }
