// TF-XLA adapter of the PyTorch port: Horovod collectives inside
// tf.function(jit_compile=True).
//
// Counterpart of horovod_tpu/native/src/tf_xla_ops.cc, with its op, its
// custom-call target and its callback setter renamed
// (HvdTpuTorchAllreduce, hvd_tpu_torch_allreduce_xla,
// HvdTpuTorchTfXlaSetCallback): TF's op registry and XLA's custom-call
// registry are process-global, and a process may load both packages'
// adapters.
//
// One custom TF op with a plain CPU kernel (eager and non-compiled
// graphs) and an XLA kernel that lowers to a host CustomCall registered
// in TF's own XLA runtime (libtensorflow_cc exports the registries; this
// file compiles against the pip package's bundled headers).  Both
// kernels re-enter Python under the GIL and run the closure the binding
// keyed into a trace-time table (horovod_tpu_torch/tensorflow/xla_ops.py):
// the tf -> torch bridge onto the port's collectives, on the session's
// device, back through a host copy.  The opaque payload carries only
// {table key, dtype, dims}.
//
// Ordering: the CustomCall has has_side_effect=true, which forbids
// CSE, DCE and reordering of collectives inside the compiled program, so
// every rank issues its collectives in trace order.

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <sstream>
#include <string>
#include <vector>

#include "tensorflow/core/framework/op.h"
#include "tensorflow/core/framework/op_kernel.h"
#include "tensorflow/core/framework/shape_inference.h"
#include "tensorflow/compiler/tf2xla/type_util.h"
#include "tensorflow/compiler/tf2xla/xla_op_kernel.h"
#include "tensorflow/compiler/tf2xla/xla_op_registry.h"
#include "xla/hlo/builder/xla_builder.h"
// The C-ABI setters (XlaCustomCallStatusSetFailure) are NOT exported by
// any of the pip package's shared objects; the struct itself is
// header-defined in the internal header, so failure is reported by
// assigning the message field directly (same ABI — this TU builds with
// tf.sysconfig's exact flags).
#include "xla/service/custom_call_status_internal.h"
#include "xla/service/custom_call_target_registry.h"
#include "xla/shape_util.h"
#include "xla/xla_data.pb.h"

namespace {

// The Python trampoline: called as cb(key, dtype_enum, dims_tuple,
// in_ptr, out_ptr) -> None.  Set once from Python after load.
PyObject* g_callback = nullptr;
std::mutex g_mu;

struct CallSpec {
  int64_t key = -1;
  int dtype = 0;
  std::vector<int64_t> dims;
};

// opaque format: "key;dtype;d0,d1,..." (dims empty for scalars).
std::string EncodeOpaque(int64_t key, int dtype,
                         const std::vector<int64_t>& dims) {
  std::ostringstream os;
  os << key << ";" << dtype << ";";
  for (size_t i = 0; i < dims.size(); ++i) {
    if (i) os << ",";
    os << dims[i];
  }
  return os.str();
}

bool DecodeOpaque(const char* opaque, size_t len, CallSpec* spec) {
  std::string s(opaque, len);
  std::istringstream is(s);
  char sep;
  if (!(is >> spec->key >> sep) || sep != ';') return false;
  if (!(is >> spec->dtype >> sep) || sep != ';') return false;
  int64_t d;
  while (is >> d) {
    spec->dims.push_back(d);
    if (!(is >> sep)) break;
  }
  return true;
}

// Invoke the Python trampoline under the GIL; returns an error string
// ("" = success).
std::string InvokePython(const CallSpec& spec, const void* in, void* out) {
  PyGILState_STATE gil = PyGILState_Ensure();
  std::string err;
  PyObject* cb;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    cb = g_callback;
    Py_XINCREF(cb);
  }
  if (cb == nullptr) {
    PyGILState_Release(gil);
    return "horovod_tpu_torch TF-XLA callback is not set (import "
           "horovod_tpu_torch.tensorflow first)";
  }
  PyObject* dims = PyTuple_New(spec.dims.size());
  for (size_t i = 0; i < spec.dims.size(); ++i) {
    PyTuple_SET_ITEM(dims, i, PyLong_FromLongLong(spec.dims[i]));
  }
  PyObject* r = PyObject_CallFunction(
      cb, "LiOKK", (long long)spec.key, spec.dtype, dims,
      (unsigned long long)(uintptr_t)in,
      (unsigned long long)(uintptr_t)out);
  if (r == nullptr) {
    PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
    PyErr_Fetch(&type, &value, &trace);
    PyObject* s = value ? PyObject_Str(value) : nullptr;
    err = s ? PyUnicode_AsUTF8(s) : "python callback failed";
    Py_XDECREF(s);
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(trace);
  } else {
    Py_DECREF(r);
  }
  Py_DECREF(dims);
  Py_XDECREF(cb);
  PyGILState_Release(gil);
  return err;
}

using tensorflow::OpKernel;
using tensorflow::OpKernelConstruction;
using tensorflow::OpKernelContext;

// ---- op definition ---------------------------------------------------------

REGISTER_OP("HvdTpuTorchAllreduce")
    .Input("tensor: T")
    .Output("output: T")
    .Attr("T: {float, double, int32, int64, bfloat16, half}")
    .Attr("table_key: int")
    .SetIsStateful()  // a collective: never CSE/prune it
    .SetShapeFn(tensorflow::shape_inference::UnchangedShape);

// ---- plain CPU kernel (eager / non-compiled graphs) ------------------------

class HvdTpuTorchAllreduceOp : public OpKernel {
 public:
  explicit HvdTpuTorchAllreduceOp(OpKernelConstruction* ctx)
      : OpKernel(ctx) {
    OP_REQUIRES_OK(ctx, ctx->GetAttr("table_key", &key_));
  }

  void Compute(OpKernelContext* ctx) override {
    const tensorflow::Tensor& in = ctx->input(0);
    tensorflow::Tensor* out = nullptr;
    OP_REQUIRES_OK(ctx, ctx->allocate_output(0, in.shape(), &out));
    CallSpec spec;
    spec.key = key_;
    spec.dtype = static_cast<int>(in.dtype());
    for (int i = 0; i < in.dims(); ++i) spec.dims.push_back(in.dim_size(i));
    std::string err = InvokePython(spec, in.tensor_data().data(),
                                   const_cast<char*>(out->tensor_data().data()));
    OP_REQUIRES(ctx, err.empty(), tensorflow::errors::Internal(err));
  }

 private:
  int64_t key_;
};

REGISTER_KERNEL_BUILDER(
    Name("HvdTpuTorchAllreduce").Device(tensorflow::DEVICE_CPU),
    HvdTpuTorchAllreduceOp);

// ---- XLA kernel: lowers to a host CustomCall -------------------------------

class HvdTpuTorchAllreduceXlaOp : public tensorflow::XlaOpKernel {
 public:
  explicit HvdTpuTorchAllreduceXlaOp(OpKernelConstruction* ctx)
      : XlaOpKernel(ctx) {
    OP_REQUIRES_OK(ctx, ctx->GetAttr("table_key", &key_));
  }

  void Compile(tensorflow::XlaOpKernelContext* ctx) override {
    const tensorflow::TensorShape shape = ctx->InputShape(0);
    xla::PrimitiveType ptype;
    OP_REQUIRES_OK(ctx, tensorflow::DataTypeToPrimitiveType(
                            ctx->input_type(0), &ptype));
    std::vector<int64_t> dims;
    for (int i = 0; i < shape.dims(); ++i) dims.push_back(shape.dim_size(i));
    xla::Shape out_shape =
        xla::ShapeUtil::MakeShapeWithDescendingLayout(ptype, dims);
    xla::Shape in_shape = out_shape;
    std::string opaque =
        EncodeOpaque(key_, static_cast<int>(ctx->input_type(0)), dims);
    std::vector<xla::Shape> operand_shapes = {in_shape};
    xla::XlaOp result = xla::CustomCallWithLayout(
        ctx->builder(), "hvd_tpu_torch_allreduce_xla", {ctx->Input(0)},
        out_shape, operand_shapes, opaque,
        /*has_side_effect=*/true,
        /*output_operand_aliasing=*/{},
        /*literal=*/nullptr,
        xla::CustomCallSchedule::SCHEDULE_NONE,
        xla::CustomCallApiVersion::API_VERSION_STATUS_RETURNING_UNIFIED);
    ctx->SetOutput(0, result);
  }

 private:
  int64_t key_;
};

REGISTER_XLA_OP(Name("HvdTpuTorchAllreduce"), HvdTpuTorchAllreduceXlaOp);

// ---- the custom-call target ------------------------------------------------

void HvdTpuTorchAllreduceXlaCallback(void* out, const void** ins,
                                const char* opaque, size_t opaque_len,
                                XlaCustomCallStatus* status) {
  CallSpec spec;
  if (!DecodeOpaque(opaque, opaque_len, &spec)) {
    status->message = "horovod_tpu_torch: bad custom-call opaque";
    return;
  }
  std::string err = InvokePython(spec, ins[0], out);
  if (!err.empty()) {
    status->message = err;
  }
}

XLA_REGISTER_CUSTOM_CALL_TARGET_WITH_SYM(
    "hvd_tpu_torch_allreduce_xla", (void*)&HvdTpuTorchAllreduceXlaCallback,
    "Host");

}  // namespace

// ---- Python-visible configuration hooks ------------------------------------

extern "C" {

// ctypes entry: install/replace the Python trampoline (py_object arg).
void HvdTpuTorchTfXlaSetCallback(PyObject* cb) {
  PyGILState_STATE gil = PyGILState_Ensure();
  std::lock_guard<std::mutex> lock(g_mu);
  Py_XINCREF(cb);
  Py_XDECREF(g_callback);
  g_callback = cb;
  PyGILState_Release(gil);
}

int HvdTpuTorchTfXlaHasCallback() {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_callback != nullptr;
}

}  // extern "C"
