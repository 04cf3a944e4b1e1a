# GENERATED by python -m mxnet_tpu_torch.tools.gen_r_ops -- do not
# edit by hand. Wrappers for every registered operator + NDArray
# function of mxnet_tpu_torch (R-package/R/mxtpu_generated.R is the
# JAX package's). Regenerate: python -m
# mxnet_tpu_torch.tools.gen_r_ops ; the tests assert exactness.

# ------------------------- symbol operators (mx.symbol.<Op>)
# Activation: Elementwise activations.
mx.symbol.Activation <- function(...) mx.symbol.op("Activation", ...)
# BatchNorm: Batch normalisation with running-stat auxiliary states.
mx.symbol.BatchNorm <- function(...) mx.symbol.op("BatchNorm", ...)
# BlockGrad: Identity forward, zero gradient (``lax.stop_gradient`` in the JAX
mx.symbol.BlockGrad <- function(...) mx.symbol.op("BlockGrad", ...)
# Concat: Concatenate along ``dim`` (default channel dim 1).
mx.symbol.Concat <- function(...) mx.symbol.op("Concat", ...)
# Convolution: 2-D convolution. Weights are OIHW in both layouts; ``layout`` only
mx.symbol.Convolution <- function(...) mx.symbol.op("Convolution", ...)
# Deconvolution: Transposed convolution. The weight is ``(channels, num_filter /
mx.symbol.Deconvolution <- function(...) mx.symbol.op("Deconvolution", ...)
# Dropout: Inverted dropout: at training time each unit is kept with
mx.symbol.Dropout <- function(...) mx.symbol.op("Dropout", ...)
# ElementWiseSum: Sum of N inputs, added left to right.
mx.symbol.ElementWiseSum <- function(...) mx.symbol.op("ElementWiseSum", ...)
# Embedding: Token embedding lookup: rows of ``weight`` (input_dim, output_dim)
mx.symbol.Embedding <- function(...) mx.symbol.op("Embedding", ...)
# Flatten: Collapse all dims after the first.
mx.symbol.Flatten <- function(...) mx.symbol.op("Flatten", ...)
# FullyConnected: Affine layer: Y = X·Wᵀ + b, weight layout (num_hidden, input_dim).
mx.symbol.FullyConnected <- function(...) mx.symbol.op("FullyConnected", ...)
# LRN: Local response normalisation across channels (axis 1):
mx.symbol.LRN <- function(...) mx.symbol.op("LRN", ...)
# LeakyReLU: Leaky, parametric, exponential and randomized rectifiers:
mx.symbol.LeakyReLU <- function(...) mx.symbol.op("LeakyReLU", ...)
# LinearRegressionOutput: Identity forward, (pred - label) gradient.
mx.symbol.LinearRegressionOutput <- function(...) mx.symbol.op("LinearRegressionOutput", ...)
# LogisticRegressionOutput: Sigmoid forward, (pred - label) gradient.
mx.symbol.LogisticRegressionOutput <- function(...) mx.symbol.op("LogisticRegressionOutput", ...)
# MAERegressionOutput: Identity forward, sign(pred - label) gradient.
mx.symbol.MAERegressionOutput <- function(...) mx.symbol.op("MAERegressionOutput", ...)
# Pooling: Max/avg/sum pooling, NCHW or NHWC per ``layout``, with floor output
mx.symbol.Pooling <- function(...) mx.symbol.op("Pooling", ...)
# Reshape: Reshape to ``target_shape`` (first dim 0 keeps the batch dim, -1
mx.symbol.Reshape <- function(...) mx.symbol.op("Reshape", ...)
# SliceChannel: Split along ``axis`` into ``num_outputs`` equal parts.
mx.symbol.SliceChannel <- function(...) mx.symbol.op("SliceChannel", ...)
# SoftmaxOutput: Softmax forward, taken in f32 (axis 1 for multi_output or N-D data,
mx.symbol.SoftmaxOutput <- function(...) mx.symbol.op("SoftmaxOutput", ...)
# Transpose: Transpose by ``axes`` (default: reverse the dims).
mx.symbol.Transpose <- function(...) mx.symbol.op("Transpose", ...)
mx.symbol.abs <- function(...) mx.symbol.op("abs", ...)
mx.symbol.exp <- function(...) mx.symbol.op("exp", ...)
mx.symbol.log <- function(...) mx.symbol.op("log", ...)
# norm: L2 norm of the whole input, as a length-1 vector: ``sqrt(sum(x²))``
mx.symbol.norm <- function(...) mx.symbol.op("norm", ...)
mx.symbol.sqrt <- function(...) mx.symbol.op("sqrt", ...)
mx.symbol.square <- function(...) mx.symbol.op("square", ...)

# ------------------- ndarray functions (mx.nd.<func>)
mx.nd.div <- function(a1, a2, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("_div", c(a1, a2), numeric(0), out)
  out
}
mx.nd.div.scalar <- function(a1, s1, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("_div_scalar", c(a1), c(s1), out)
  out
}
mx.nd.minus.scalar <- function(a1, s1, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("_minus_scalar", c(a1), c(s1), out)
  out
}
mx.nd.mul <- function(a1, a2, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("_mul", c(a1, a2), numeric(0), out)
  out
}
mx.nd.onehot.encode <- function(a1, a2, out) {
  .mxr.func("_onehot_encode", c(a1, a2), numeric(0), out)
  out
}
mx.nd.plus.scalar <- function(a1, s1, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("_plus_scalar", c(a1), c(s1), out)
  out
}
mx.nd.random.gaussian <- function(s1, s2, out) {
  .mxr.func("_random_gaussian", integer(0), c(s1, s2), out)
  out
}
mx.nd.random.uniform <- function(s1, s2, out) {
  .mxr.func("_random_uniform", integer(0), c(s1, s2), out)
  out
}
mx.nd.rdiv.scalar <- function(a1, s1, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("_rdiv_scalar", c(a1), c(s1), out)
  out
}
mx.nd.rminus.scalar <- function(a1, s1, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("_rminus_scalar", c(a1), c(s1), out)
  out
}
mx.nd.set.value <- function(s1, out) {
  .mxr.func("_set_value", integer(0), c(s1), out)
  out
}
mx.nd.choose.element.0index <- function(a1, a2, out) {
  .mxr.func("choose_element_0index", c(a1, a2), numeric(0), out)
  out
}
mx.nd.clip <- function(a1, s1, s2, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("clip", c(a1), c(s1, s2), out)
  out
}
mx.nd.exp <- function(a1, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("exp", c(a1), numeric(0), out)
  out
}
mx.nd.log <- function(a1, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("log", c(a1), numeric(0), out)
  out
}
mx.nd.sqrt <- function(a1, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("sqrt", c(a1), numeric(0), out)
  out
}
mx.nd.square <- function(a1, out = NULL) {
  if (is.null(out)) out <- .mxr.nd.alloc(mx.nd.shape(a1))
  .mxr.func("square", c(a1), numeric(0), out)
  out
}
