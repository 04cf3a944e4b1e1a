// An embedding C host of the port's flat C API: trains a small MLP through
// MX* calls only, as an external binding would, and prints its losses.
//
//   torch_capi_host DEV_TYPE SEED STEPS
//
// DEV_TYPE is the reference's code (1 cpu, 2 the card). The host seeds the
// framework's generators (MXRandomSeed), builds tests/test_c_api.py's MLP
// (data -> FullyConnected(4) -> relu -> FullyConnected(2) -> SoftmaxOutput)
// with CreateAtomicSymbol + Compose, makes its arguments on DEV_TYPE, draws
// the weights with the registered _random_gaussian, and takes STEPS SGD
// steps of batch 8 over 40 fixed rows (eighths, so exact in float), the
// update through MXFuncInvoke. Each step prints "loss <step> <value>", the
// batch's mean cross-entropy in double, then the host exits 0; any failed
// call prints MXGetLastError to stderr and exits 1. chip_smoke.py's
// capi_mlp runs the same sequence through ctypes.
//
// Build against the library mxnet_tpu_torch.native.capi.build_capi()
// returns (in DIR):
//   g++ -O2 -std=c++17 torch_capi_host.cc -o torch_capi_host
//       -I<repo>/mxnet_tpu_torch/native -LDIR -lmxtpu_torch_capi
//       -Wl,-rpath,DIR
// and run it with PYTHONPATH holding the repository and the interpreter's
// site-packages (mxnet_tpu_torch.native.capi.embedding_env).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "mxtpu_c_api.h"

namespace {

const int kRows = 40, kBatch = 8, kIn = 3, kHidden = 4, kOut = 2;
const float kLr = 0.5f, kWeightSd = 0.3f;

void check(int rc, const char* what) {
  if (rc != 0) {
    std::fprintf(stderr, "%s failed: %s\n", what, MXGetLastError());
    std::exit(1);
  }
}

AtomicSymbolCreator creator(const char* op) {
  mx_uint n = 0;
  AtomicSymbolCreator* all = nullptr;
  check(MXSymbolListAtomicSymbolCreators(&n, &all), "ListAtomicSymbolCreators");
  std::vector<AtomicSymbolCreator> creators(all, all + n);
  for (AtomicSymbolCreator c : creators) {
    const char *name, *desc, *kv;
    mx_uint nargs;
    const char **an, **at, **ad;
    check(MXSymbolGetAtomicSymbolInfo(c, &name, &desc, &nargs, &an, &at, &ad,
                                      &kv), "GetAtomicSymbolInfo");
    if (std::strcmp(name, op) == 0) return c;
  }
  std::fprintf(stderr, "operator %s not found\n", op);
  std::exit(1);
}

SymbolHandle layer(const char* op, const char* name, SymbolHandle input,
                   const char* key = nullptr, const char* val = nullptr) {
  SymbolHandle s;
  const char* keys[1] = {key};
  const char* vals[1] = {val};
  check(MXSymbolCreateAtomicSymbol(creator(op), key ? 1 : 0, keys, vals, &s),
        "CreateAtomicSymbol");
  const char* in_keys[1] = {"data"};
  SymbolHandle in_args[1] = {input};
  check(MXSymbolCompose(s, name, 1, in_keys, in_args), "Compose");
  return s;
}

NDArrayHandle array(std::vector<mx_uint> shape, int dev_type) {
  NDArrayHandle h;
  check(MXNDArrayCreate(shape.data(), (mx_uint)shape.size(), dev_type, 0, 0,
                        &h), "NDArrayCreate");
  return h;
}

FunctionHandle function(const char* name) {
  FunctionHandle f;
  check(MXGetFunction(name, &f), "GetFunction");
  return f;
}

float cell(int r, int c) {  // the fixed rows: eighths in [-1, 1]
  return static_cast<float>((r * 7 + c * 13 + 5) % 17 - 8) / 8.0f;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 4) {
    std::fprintf(stderr, "usage: %s DEV_TYPE SEED STEPS\n", argv[0]);
    return 2;
  }
  const int dev_type = std::atoi(argv[1]);
  const int seed = std::atoi(argv[2]);
  const int steps = std::atoi(argv[3]);
  check(MXRandomSeed(seed), "RandomSeed");

  SymbolHandle data;
  check(MXSymbolCreateVariable("data", &data), "CreateVariable");
  SymbolHandle net = layer("FullyConnected", "fc1", data, "num_hidden", "4");
  net = layer("Activation", "relu1", net, "act_type", "relu");
  net = layer("FullyConnected", "fc2", net, "num_hidden", "2");
  net = layer("SoftmaxOutput", "softmax", net);

  // data, fc1_weight, fc1_bias, fc2_weight, fc2_bias, softmax_label
  const std::vector<std::vector<mx_uint>> shapes = {
      {kBatch, kIn}, {kHidden, kIn}, {kHidden}, {kOut, kHidden}, {kOut},
      {kBatch}};
  const int n_args = static_cast<int>(shapes.size());
  std::vector<NDArrayHandle> args, grads;
  std::vector<mx_uint> reqs;
  FunctionHandle gaussian = function("_random_gaussian");
  FunctionHandle set_value = function("_set_value");
  for (int i = 0; i < n_args; ++i) {
    args.push_back(array(shapes[i], dev_type));
    bool param = i > 0 && i < n_args - 1;
    grads.push_back(param ? array(shapes[i], dev_type) : nullptr);
    reqs.push_back(param ? 1 : 0);  // write, null
    if (!param) continue;
    NDArrayHandle out[1] = {args[i]};
    if (i == 1 || i == 3) {
      float sc[2] = {0.0f, kWeightSd};
      check(MXFuncInvoke(gaussian, nullptr, sc, out), "_random_gaussian");
    } else {
      float sc[1] = {0.0f};
      check(MXFuncInvoke(set_value, nullptr, sc, out), "_set_value");
    }
  }
  ExecutorHandle exec;
  check(MXExecutorBind(net, dev_type, 0, n_args, args.data(), grads.data(),
                       reqs.data(), 0, nullptr, &exec), "ExecutorBind");

  FunctionHandle mul_scalar = function("_mul_scalar");
  FunctionHandle minus = function("_minus");
  NDArrayHandle scratch[6] = {nullptr};
  for (int i = 1; i < n_args - 1; ++i) scratch[i] = array(shapes[i], dev_type);

  std::vector<float> x(kBatch * kIn), y(kBatch), prob(kBatch * kOut);
  for (int step = 0; step < steps; ++step) {
    for (int b = 0; b < kBatch; ++b) {
      int r = (step * kBatch + b) % kRows;
      for (int c = 0; c < kIn; ++c) x[b * kIn + c] = cell(r, c);
      y[b] = (cell(r, 0) + cell(r, 1) - cell(r, 2) > 0.0f) ? 1.0f : 0.0f;
    }
    check(MXNDArraySyncCopyFromCPU(args[0], x.data(), x.size()), "copy data");
    check(MXNDArraySyncCopyFromCPU(args[n_args - 1], y.data(), y.size()),
          "copy label");
    check(MXExecutorForward(exec, 1), "Forward");
    mx_uint n_out;
    NDArrayHandle* outs;
    check(MXExecutorOutputs(exec, &n_out, &outs), "Outputs");
    check(MXNDArraySyncCopyToCPU(outs[0], prob.data(), prob.size()),
          "copy output");
    for (mx_uint i = 0; i < n_out; ++i) check(MXNDArrayFree(outs[i]), "Free");
    double loss = 0.0;
    for (int b = 0; b < kBatch; ++b)
      loss -= std::log(static_cast<double>(
          prob[b * kOut + static_cast<int>(y[b])]));
    std::printf("loss %d %.17g\n", step, loss / kBatch);
    check(MXExecutorBackward(exec, 0, nullptr), "Backward");
    for (int i = 1; i < n_args - 1; ++i) {  // w -= lr / batch * g
      float sc[1] = {kLr / kBatch};
      NDArrayHandle use[2] = {grads[i], nullptr};
      NDArrayHandle out[1] = {scratch[i]};
      check(MXFuncInvoke(mul_scalar, use, sc, out), "_mul_scalar");
      NDArrayHandle use2[2] = {args[i], scratch[i]};
      NDArrayHandle out2[1] = {args[i]};
      check(MXFuncInvoke(minus, use2, nullptr, out2), "_minus");
    }
  }
  std::fflush(stdout);
  check(MXNotifyShutdown(), "NotifyShutdown");
  return 0;
}
