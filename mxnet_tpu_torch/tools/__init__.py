"""The port's counterparts of the JAX package's user tools under
``tools/``, each run as ``python -m mxnet_tpu_torch.tools.<name>`` with the
JAX script's command line:

- ``caffe_converter``: a Caffe prototxt and its weights to a Symbol and a
  checkpoint pair (``tools/caffe_converter/``);
- ``im2rec``: images to a RecordIO file (``tools/im2rec.py``);
- ``gen_op_docs``: the operator reference page ``doc/ops.md`` of this
  package (``tools/gen_op_docs.py``);
- ``gen_r_ops``: the R binding's generated wrappers
  ``bindings/r/mxtpu_generated.R`` (``tools/gen_r_ops.py``);
- ``run_mxlint``: the lint over this package (``tools/run_mxlint.py``);
- the measurement tools, each on the card and writing its ``--out`` (a
  name of its own, never the JAX tools' files at the repository's root):
  ``bench_flash`` (the flash kernels' rates), ``bench_longctx`` (the LM's
  step by sequence length), ``bench_mnist`` (MLP and LeNet steps),
  ``bench_roofline`` (ResNet-50's step against the card's bandwidth;
  ``--analyze-only --cpu`` counts on the CPU), ``bench_io_scaling`` (the
  native pipeline by thread count) and ``scaling_projection`` (data
  parallel scaling projected from one card); ``_bench`` holds what they
  share (``bench.py``'s helpers);
- ``bench.py``'s thirteen subsystem acceptance benches, each pricing one
  subsystem against the bound its JAX counterpart set and publishing one
  JSON line through ``telemetry.ledger.publish_bench`` (full runs under
  ``build/bench_subsystems/``): ``bench_telemetry``, ``bench_trace``,
  ``bench_mem``, ``bench_health``, ``bench_profile``, ``bench_comm``,
  ``bench_overlap``, ``bench_kernels``, ``bench_elastic``, ``bench_ckpt``,
  ``bench_lockwatch``, ``bench_controller`` and ``bench_compile``;
  ``_subsystem`` holds what they share (the dp-8 MLP over eight replicas
  of one device, the host timer, the arguments, the exit).

``import mxnet_tpu_torch`` imports none of them. ``tools/launch.py`` needs
no counterpart: it imports neither package and only sets the ``MXTPU_*``
and ``DMLC_*`` variables that the port's kvstores read.
"""
