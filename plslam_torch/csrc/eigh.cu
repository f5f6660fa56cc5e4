// Symmetric eigendecompositions in float64 through cuSOLVER, queued on the
// caller's stream with no host wait.
//
// Replaces no TPU kernel. The marginalization (plslam_torch/models/
// marginalization.py) decomposes three float64 matrices a MARGIN_OLD frame
// (64 4x4 line blocks, a 15x15 and a 163x163 block at the benchmark's
// widths) and two a MARGIN_SECOND_NEW frame (6x6, 172x172).
// `torch.linalg.eigh` runs a single matrix through cuSOLVER's `syevd` and a
// batch through `cusolverDnXsyevBatched`, then reads LAPACK's `info` back to
// the host after every call to raise on a failure. `syevd` (and `syevj`)
// also copy to pageable host memory inside the call: on an H100 each took
// ~100 ms of host time behind a 100-ms sleep at every size from 4 to 172.
// The host then waits for everything queued before the call, which in the
// estimator is the window's LM solve. `cusolverDnXsyevBatched` stays on the
// card at every one of these sizes, a batch of one matrix included (0.4-1.1
// ms of host time behind the same sleep, no host workspace), and gives
// `torch.linalg.eigh`'s eigenvalues and eigenvectors bit for bit at each of
// them; so every call here takes it, and `info` (one a matrix) stays on the
// card for the caller to fold into a flag that reaches the host with a
// readback it makes anyway.
//
// Eigenvalues ascending; eigenvectors in the columns of the column-major
// result, which overwrites the caller's row-major copy of a symmetric matrix
// (the same bytes): row j of the buffer becomes eigenvector j.
//
// One cuSOLVER handle (and its parameter object) a device, made at the first
// call; each call binds the handle to the caller's stream under a mutex,
// since ctypes releases Python's lock during the call.
#include <cuda_runtime.h>
#include <cusolverDn.h>

#include <mutex>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kBadArgument = 900;  // not a cusolverStatus_t
constexpr int kCudaError = 1000;   // + the cudaError_t

struct Solver {
  cusolverDnHandle_t handle = nullptr;
  cusolverDnParams_t params = nullptr;
};

Solver g_solvers[kMaxDevices];
std::mutex g_mutex;

// Makes `dev` current for the scope; restores the previous device.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int dev) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    int cur = -1;
    if (prev >= 0 && cudaGetDevice(&cur) == cudaSuccess && cur != prev) cudaSetDevice(prev);
  }
};

// The device's solver, made on first use. Called with g_mutex held and the
// device current.
int solver_for(int dev, Solver** out) {
  Solver& s = g_solvers[dev];
  if (s.handle == nullptr) {
    cusolverDnHandle_t h = nullptr;
    cusolverStatus_t st = cusolverDnCreate(&h);
    if (st != CUSOLVER_STATUS_SUCCESS) return static_cast<int>(st);
    cusolverDnParams_t p = nullptr;
    st = cusolverDnCreateParams(&p);
    if (st != CUSOLVER_STATUS_SUCCESS) {
      cusolverDnDestroy(h);
      return static_cast<int>(st);
    }
    s.handle = h;
    s.params = p;
  }
  *out = &s;
  return 0;
}

const cusolverEigMode_t kJobz = CUSOLVER_EIG_MODE_VECTOR;
const cublasFillMode_t kUplo = CUBLAS_FILL_MODE_LOWER;

}  // namespace

// The workspaces, in bytes on the device and on the host, that
// `plslam_eigh_f64` needs at n rows and `batch` matrices. `a` and `w` are
// device buffers of that shape (read by no one: cuSOLVER's size query takes
// them).
extern "C" int plslam_eigh_f64_workspace(int dev, long n, long batch, const double* a,
                                         const double* w, size_t* device_bytes,
                                         size_t* host_bytes) {
  if (n < 1 || batch < 1 || dev < 0 || dev >= kMaxDevices) return kBadArgument;
  std::lock_guard<std::mutex> lock(g_mutex);
  DeviceGuard guard(dev);
  if (guard.err != cudaSuccess) return kCudaError + static_cast<int>(guard.err);
  Solver* s = nullptr;
  const int rc = solver_for(dev, &s);
  if (rc != 0) return rc;
  return static_cast<int>(cusolverDnXsyevBatched_bufferSize(
      s->handle, s->params, kJobz, kUplo, n, CUDA_R_64F, a, n, CUDA_R_64F, w, CUDA_R_64F,
      device_bytes, host_bytes, batch));
}

// Decomposes `batch` symmetric n x n matrices at `a` (contiguous; only the
// lower triangle is read; overwritten by the eigenvectors) into ascending
// eigenvalues `w` [batch, n], with one `info` a matrix, on `stream`. Queues
// the work and returns: nothing is read back, nothing waits. Returns 0, a
// cusolverStatus_t, kBadArgument, or kCudaError + a cudaError_t.
extern "C" int plslam_eigh_f64(int dev, double* a, double* w, long n, long batch, void* work,
                               size_t device_bytes, void* host_work, size_t host_bytes,
                               int* info, void* stream) {
  if (n < 1 || batch < 1 || dev < 0 || dev >= kMaxDevices) return kBadArgument;
  std::lock_guard<std::mutex> lock(g_mutex);
  DeviceGuard guard(dev);
  if (guard.err != cudaSuccess) return kCudaError + static_cast<int>(guard.err);
  Solver* s = nullptr;
  const int rc = solver_for(dev, &s);
  if (rc != 0) return rc;
  cusolverStatus_t st = cusolverDnSetStream(s->handle, static_cast<cudaStream_t>(stream));
  if (st != CUSOLVER_STATUS_SUCCESS) return static_cast<int>(st);
  st = cusolverDnXsyevBatched(s->handle, s->params, kJobz, kUplo, n, CUDA_R_64F, a, n, CUDA_R_64F,
                              w, CUDA_R_64F, work, device_bytes, host_work, host_bytes, info,
                              batch);
  return static_cast<int>(st);
}
