"""The bindings around the port's native libraries.

Counterparts of the JAX package's files outside its package:
``amalgamation`` (``amalgamation/amalgamation.py``: the native predictor
as one C++ file), ``mxtpu_predict`` (``predict/python/mxtpu_predict.py``: a
ctypes-only predictor module that imports nothing of the port) and ``r/``
(``R-package/src/*.cc``: the C side of the R binding, ``mxtpu_shim.cc``
over the native predictor and ``mxtpu_r_train.cc`` over the flat C API).
The R scripts themselves are not ported. Nothing here is imported by the
package itself.
"""
