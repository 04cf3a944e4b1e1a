#!/usr/bin/env python3
"""Smoke run of mxnet_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

from the root of a checkout. It needs one card, builds every CUDA kernel of
the port from ``mxnet_tpu_torch/csrc`` (one nvcc per source, all started
together), and then:

1. card: prints the card's name and power limit as nvidia-smi reports them,
   and the kernels' build time; the host compiler builds the native data
   pipeline and the bindings' libraries beside nvcc, and the lint's CLI
   (phase mxlint's part (c)) starts beside them and runs on beside the
   phases that follow until phase mxlint reads it;
2. kernels: holds int8_matmul against its plain PyTorch version on the card,
   bitwise, at the shapes the serving path gives it and a few more (split K
   at small M, none at the large shape), also after the allocator's free
   blocks are filled with NaN (the GEMM overlaps its row pre-pass), and
   times it (CUDA events, L2
   flushed, median) beside its bound, its plain version and the library
   calls that compute the same contraction;
3. slice (serving): serves a full-width ResNet-50 (batch 32, 3x224x224, 1000
   classes, seeded random weights) through
   ``Predictor(ctx=gpu(0), quantize="int8")`` and with ``quantize=None``,
   checks the outputs, that every int8 request launched the kernel, and the
   card's results against the CPU's on two images, and prints request
   latency and images per second;
4. fused_adam: holds the multi-tensor Adam kernel bitwise against its plain
   version and against the per-leaf ``Optimizer.apply``, over 3 steps, on
   ResNet-50's 161 parameters and on an odd set, for Adam (rescale, clip,
   L2 decay) and AdamW (decay filter), and times it beside its bound, its
   plain version and ``torch.optim.Adam(fused=True)``;
5. train (training slice): trains the full-width ResNet-50 (batch 32) for 8
   steps through ``FeedForward(ctx=gpu(0), optimizer="adam", fused=True)``,
   checks that every step launched the kernel once, that the loss and the
   parameters are finite and moved, that the loss of the batch it overfits
   fell, and the card's gradients at batch 4 against the CPU's and against a
   float64 CPU run, and prints the step time, images per second and one
   step's forward / backward / update split;
5a. train_bf16: the same ResNet-50 with ``compute_dtype=torch.bfloat16``:
   one training forward against f32 (loss within BF16_LOSS_BOUND, centred
   log-probabilities within BF16_LOGITS_BOUND) and two planted faults (the
   loss head's softmax summed in bf16, gated above the bounds; BatchNorm
   statistics in bf16, reported), then 8 fit steps plain, plain again and
   under ``MXNET_TPU_REMAT='unit\\d+_out$'`` captured and eager
   (``MXTPU_CUDA_GRAPHS=0``), and phase train's f32 fit under
   ``set_matmul_precision("default")`` (TF32); checks fused_adam once a
   step, the loss falling, the bf16 fit's first loss against f32's, remat's
   first loss bitwise the plain one's, its update within REMAT_UPDATE_BOUND
   of the plain one's (the plain run repeated shows cuDNN's run-to-run
   spread) and its peak memory below the plain run's, the remat fit
   captured (one capture, no eager reason) with its update within the same
   bound of the eager remat fit's; prints step time, images per second, the
   forward / backward / update split, peak memory and captures of each
   run;
5b. serve_bf16: phase slice's int8 request under ``"highest"`` and
   ``"default"`` (int8_matmul launched on every request), and the bf16
   ``FeedForward.predict`` of the same weights against the f32 logits;
5c. zoo: full-width AlexNet (LRN, Dropout) and Inception-BN at 3x224x224,
   batch 32, bf16, fused Adam, 6 steps each (the mean loss of the last
   three steps below the first three's: Dropout moves each), AlexNet again
   under remat with a boundary after each LRN and after its last Dropout,
   captured, eager and captured with a planted recompute that draws other
   Dropout masks: the first loss bitwise the plain one's, the captured
   remat fit (one capture, no eager reason) within REMAT_UPDATE_BOUND of
   the eager remat fit's update and the planted one above it, 4 steps at lr
   0 captured and eager bitwise (the masks), and one step's gradients with
   and without remat from the same generator state within
   ZOO_REMAT_GRAD_BOUND, where the planted recompute lands above it; then
   one training step of an MLP at width 2048, batch 8192, with a Dropout
   after each of its 8 layers, plain and under remat (a boundary after
   each Dropout): the remat tape holds one byte a Dropout element (the
   bool masks; a planted tape of f32 uniforms reads four) and remat's
   peak memory is below the plain step's;
5d. ndarray: the imperative NDArray on the card at 4096 x 4096: arithmetic,
   in-place operators, slices, writes, reductions and ``dot`` against numpy
   on the same values (bitwise, or against f64 within 1e-4 / 1e-5), copies
   across ``gpu(0)``, ``cpu()`` and ``cpu_pinned()``, ``wait_to_read`` and
   ``waitall`` returning with the stream idle, and ``random.get_state`` /
   ``set_state`` repeating the card's draws bitwise;
5e. monitor: a ``Monitor`` on a bf16 ResNet-50 executor for two training
   steps, one finite statistic for each of the 16 unit outputs, named as
   ``get_internals().list_outputs()`` names them;
5f. io_feed: writes a RecordIO shard of 512 PNG records (smooth
   gradients, sides drawn from 256-480, the port's own PNG encoder), reads
   one epoch through ``ImageRecordIter`` at the JAX package's io bench
   settings (batch 32, 3x224x224, shuffle, random crop and mirror,
   resize 256, prefetch 8, seed 7, uint8) with one decode thread a host
   core, checks the epoch's shapes and that 4 batches equal a second
   iterator's with the same seed, and prints the feed-only images per
   second;
5g. io_fit: bf16 ResNet-50 (Xavier, SGD lr 0.01, momentum 0.9) trained
   for one epoch (16 steps, the first a warm-up) through
   ``FeedForward.fit`` from that iterator, with the device feed (a thread,
   pinned buffers, its own stream and an event), again with
   ``MXTPU_FEED_PREFETCH=0`` and on one cached batch; checks at every step
   that the batch the step read on the card equals the host batch (an
   exact int64 digest of both), that a planted off-by-one feed (each step
   reads the previous step's batch) is caught at every step after the
   first, that the loss is finite and the parameters moved; prints the
   step time, images per second and the feed's wait a step of each run,
   and over steps 13-16 (the steady state) the card's idle share;
5h. lstm_bucketing: ``BucketingModule.fit`` of ``lstm_unroll`` at the
   widths of MXNet's PTB bucketing example (2 layers, 200 hidden, 200
   embedding, vocabulary 10,000, buckets 10-60, batch 32, SGD lr 0.5) over
   a synthetic Zipf(1.2) corpus, one epoch (each bucket's executor
   captures its training forward and backward as a pair of CUDA graphs
   before its first step, then replays it); checks the first step's loss
   against the same step on the CPU within LSTM_CPU_BOUND, that every
   bucket ran, and that after a step on bucket 10 bucket 50's executor
   reads the updated weights bitwise, where a planted bucket that copies
   its weights is caught; prints the step time per bucket and tokens per
   second;
5i. lstm_scan: ``LSTMLM`` (the time loop in torch) at the same widths,
   sequence 64, batch 32: the forward's logits against the CPU's within
   LSTM_SCAN_LOGIT_BOUND, 8 SGD-momentum steps with a falling loss, the
   first against the CPU's step within LSTM_CPU_BOUND; prints forward and
   step times and tokens per second;
5l. io_native: the PNG shard's images re-encoded as JPEG (the native
   codec, quality 95) through ``ImageRecordIter``'s native route, which it
   must take; on sampled records PIL's encode gives the native encoder's
   bytes and PIL's decode the native decoder's pixels exactly, and they
   decode near their source pixels; a deterministic iterator (no shuffle or random augmentation,
   centre crops, batch 30) bitwise between 1 and 8 pipeline threads and
   against each record's own native decode, labels in order, the last
   batch padded as round_batch pads; feed-only images per second at 1, 2,
   4 and 8 threads; bf16 ResNet-50 through ``fit`` from the JPEG shard (the
   main path; every step's batch digested) against phase io_fit's PNG
   and cached-batch fits, and the decode-thread sweep on the PNG and the
   JPEG shard: 1, 2 and 4 threads on half the shard with as many
   prefetched batches as threads, and the host's cores from the whole-epoch fits: steady ms a
   step, the feed's wait and the card's device time and idle share
   (torch.profiler) of each;
5m. native_progressive: 16 records of the PNG shard re-encoded by PIL as
   progressive JPEG (qualities 95/75/50, subsamplings 4:4:4/4:2:2/4:2:0)
   decode through the native codec to PIL's pixels exactly; a shard of the
   first 256 records, baseline up to record 64 and every other record
   progressive after it, keeps ``ImageRecordIter``'s native route for a
   whole epoch (the main path, no kernel), each image bitwise its record
   decoded alone; decode ms per image, progressive and baseline;
5n. native_arith: the arithmetic-coded JPEG files that
   ``tests/torch_arith_jpeg.py`` carries (SOF9 and SOF10, 4:2:0 and gray,
   restarts, non-default DAC conditioning) decode through the native codec
   to this machine's PIL pixels exactly where its PIL reads them, else to
   the carried digests of the pixels PIL gave where they were written (the
   row says which); a shard of Huffman records with arithmetic ones from
   the second batch on keeps ``ImageRecordIter``'s native route for a
   whole epoch (the main path, no kernel), each image bitwise its record
   decoded alone;
5j. graphs: captured against eager (``MXTPU_CUDA_GRAPHS=0``) in one
   process: ResNet-50 at batch 32 in f32 ``"highest"`` with fused Adam
   (phase train's), and bf16 with SGD momentum on one cached batch
   (io_fit's), 8 steps each, captured, eager and eager again, the
   captured parameters within twice the eager runs' spread (the largest
   difference, and the difference over the eager run's movement from the
   initial weights), two planted captured Adam steps (no update after the
   warm-up; lr, c1 and c2 baked in at the capture) read above the second
   bound, one capture and 7
   replays, fused_adam counted once a step by replay, and step ms,
   images per second, the card's device time and idle share
   (torch.profiler), capture seconds and graph-pool bytes of each;
   fused_adam replayed with its per-step vector refreshed (lr halved
   every 2 steps, Adam's bias corrections moving) bitwise the eager
   launches over 8 steps at ResNet-50's 161 leaves, and a planted graph
   with lr, c1 and c2 baked in read above the bound; a planted stale
   static buffer (the feed's copies go to new buffers after the capture)
   caught at every replay after it by the in-step digest; the PTB-width
   bucketed LSTM through ``BucketingFeedForward`` precompiled (every
   bucket captured, none in the fit after it), captured as it goes and
   eager, bitwise, a FactorScheduler moving lr; the int8 Predictor at
   batch 32, replayed and eager, logits bitwise, int8_matmul counted
   once a request, and int8_matmul alone replayed on 9 inputs bitwise its
   plain version after a NaN-filled allocator; AlexNet's Dropout masks
   (bf16, lr 0) bitwise the eager steps' and different between replays;
   a ResNet-50 Executor (batch 32, f32) after ``precompile(is_train=True)``
   (its forward and backward captured as a pair of graphs), 3 replayed
   ``forward(is_train=True)``/``backward()`` steps on new data against
   eager and eager again, the gradients, running statistics and outputs
   within twice the eager runs' spread (bitwise where that is 0), two
   captures and 6 replays; ``Module.fit`` of an MLP (batch 64, SGD
   momentum, 8 steps) captured against eager by the same rule;
5k. ckpt: save_sharded, load_sharded, one capture_snapshot's stall and
   the writer's background time at ResNet-50's 161 leaves (fused Adam's
   state); a fit of 6 steps with ``checkpoint_every_n_steps=2`` killed
   after step 5
   (an exception from a batch callback) and resumed on the same object
   (its captured steps reused) against the uninterrupted fit: bf16
   ResNet-50 with fused Adam within twice the spread of two uninterrupted
   fits (0: bitwise), fused_adam counted once a resumed step by replay
   (the phase's launches), the bucketed LSTM bitwise; a corrupted newest
   step skipped by latest_step; a planted resume that rebinds the
   parameter tensors instead of copying into the captured buffers caught;
   lm_train and dp_train report fused_adam's leaf-table builds (one a
   run: fresh gradients upload only their pointers);
5o. telemetry: full-width ResNet-50 (batch 32, bf16 ``compute_dtype``,
   fused Adam, captured steps) fitted 20 steps with ``telemetry=`` (a
   JSONL stream), ``health=True`` and ``profile=ProfileConfig(steps=4,
   warmup=4)``, the lock watchdog armed and the flight recorder and run
   ledger writing into a directory of their own, then one
   ``predict(telemetry=, profile=)``; the same fit with all of it off
   first, in this process. Gates: no eager step outside the profile
   window (its 4 steps counted under ``profile window``), one capture and
   14 replays, fused_adam once a step; the health vectors of step 11
   within TELEMETRY_HEALTH_BOUND of an f64 recomputation on the card from
   that step's weights before and after and its gradients, nonfinite
   exactly 0, and a NaN planted in one leaf's gradient counted once on
   its layer and blamed by ``HealthMonitor``; every device event of the
   window's chrome trace in exactly one report row, the rows summing to
   the trace's total, fused_adam one row under ``optimizer`` with one
   launch a window step; the counted step's contraction FLOPs within 1%
   of an analytic count from the 53 convolutions' and the FC layer's
   shapes; every JSONL line with its golden keys, a flight dump that
   validates, the fit's and predict's ledger records with their CRCs,
   no lock-order cycle; each captured program's memory plan with
   temporaries. Prints the coverage beside the timeline's phases, the
   measured bf16 peak and the MFU, the armed watchdog's cost a step, the
   live-array watermark beside ``max_memory_allocated`` and the step time
   with everything on beside the same fit with it off;
5p. guards: full-width ResNet-50 (batch 32, f32, fused Adam, captured)
   through ``fit(guards=True)`` with the ``step.nan`` chaos site poisoning
   step 4: the parameters, both Adam moments and the running statistics
   after it bitwise as before it, ``guard_stats`` one skip, fused_adam
   once a step (by replay), Adam's step counts one short; the captured
   guarded fit bitwise the eager one (cuDNN's deterministic algorithms in
   both); a bf16 fit with a dynamic loss scale (2^15) backing off once;
   the guarded captured step's median against the unguarded one's (host
   clock around synchronised steps, 16-step fits in turn, twice),
   reported beside the JAX package's 5% bound; SIGTERM after step 4 of a
   fit with ``sharded_checkpoint_dir`` and a step cadence: the flush at
   step 4, TrainingPreempted, and the resumed fit bitwise the
   uninterrupted one;
5q. elastic: full-width ResNet-50 (f32, fused Adam, int8 with overlap,
   the comm kernels, epoch checkpoints) through ``fit(elastic=)`` over
   ``[gpu(0)] * 4`` (one replica an entry), batch 48, 4 steps an epoch, 3
   epochs, cuDNN deterministic: a seeded ``elastic.kill`` before epoch
   1's fourth step and ``elastic.rejoin`` in epoch 2 (history [3, 4]);
   the redone epoch's checkpoint bitwise that of a fresh world-3 fit
   resumed from the copied pre-kill checkpoint (parameters, Adam
   moments, residual ledgers); resize badput above 0 and one resize span
   a resize; fused_adam and the int8 comm kernels launched on every
   world; the allocated memory after the regrow within 5% of before the
   kill at the same step of an epoch. Prints each resize's downtime;
5r. controller: the same model and world (6 steps an epoch),
   uncompressed at the start,
   through ``fit(elastic=, controller=)`` with the JAX package's e2e
   faults (tests/test_controller.py:515-576): a straggler stalled by a
   real sleep and blamed through scripted spans, a flaky rank whose
   heartbeats stop and resume, the wire's rate scaled to a comm:compute
   ratio of 0.5: the straggler evicted once, the flaky rank backfilled,
   one retier (int8) whose kernels launch after it, the breaker closed, a
   valid flight dump with controller incidents, no controller or
   heartbeat thread left; then a short fit that stages an unappliable
   tier twice: the controller frozen, the fit finished;
6. flash: holds the three flash-attention kernels (forward, dq, dk/dv)
   against their plain versions on the card, row by row, and lse at f32's
   precision, at the transformer LM's shape (q, k, v views of one packed
   qkv, 8x8x2048x64 bf16, causal), at a non-causal shape, at a ragged f32
   one, at the bf16 Hopper kernels' edges (head_dim 32, 40 and 128,
   sequences of 77 and 1000, seq_q != seq_k), at batch x heads 65,536
   (one linear grid) and at the forms bench_flash times in 12e (f32 at
   head_dim 64 and 128, causal and not, and bf16 causal at 128, at 1 x 4 x
   2048), checks that two launches agree bitwise, and times
   each beside its bound, its plain version and
   ``F.scaled_dot_product_attention`` (forward, or its backward), with its
   share of the bound and its compiled registers, shared memory and spills
   at the LM's head_dim and at 128;
7. lm_serve: the full-width transformer LM (vocab 32000, d_model 512, 8
   heads, 4 layers, d_ff 2048, bf16, seeded random weights) computes the
   logits of 8 sequences of 2048 tokens through ``TransformerLM.forward``,
   checks them, that each forward launched ``flash_fwd`` 4 times, and the
   card against the CPU on 1 x 256 tokens in f32, and prints latency and
   tokens per second;
8. lm_train: trains that LM for 8 steps through ``make_train_step`` with
   ``Adam(fused=True)`` on one fixed batch of 8 x 2048 tokens (the step
   captured since slice 16: the first eager, then one capture and
   replays), checks the launches per step (4 of each flash kernel, 1
   ``fused_adam``, counted by replay), the captured program's fused_adam
   table built once, that the
   loss fell and the parameters are finite and moved, and the card's
   gradients at 1 x 256 tokens in f32 against the CPU's, and prints the
   step time, tokens per second and the forward / backward / update split;
   lm_graphs: 8 steps of that LM's ``make_train_step`` captured, eager
   (``MXTPU_CUDA_GRAPHS=0``) and eager again, from the same parameters,
   over two alternating batches: losses and parameters within twice the
   eager runs' spread (bitwise where that is 0), one capture and 7
   replays, 4 of each flash kernel and one ``fused_adam`` a step counted
   by replay, a planted stale token buffer (the program's buffer rebound
   after its capture) reading above the bound; step ms, tokens per
   second, device time and idle share of the captured and eager steps;
   lm_head: the LM's logits GEMM and its two gradients alone at the full
   shape (bf16 operands, f32 sums on the tensor cores, the cotangent split
   in two bf16 parts), each product within 2^-16 of sum |a||b| of the f64
   product, the gradients bitwise the split products rounded once, timed
   beside the f32 CUDA-core route they replace;
9. comm_kernels: holds the six gradient-compression kernels bitwise against
   their plain versions on the card (NaN by position), at ResNet-50's
   padded gradient split into 2, 4 and 8 rows, at (8, 2048) with chunk 256
   and ``block_elems`` 512 and at a 1-D (64,) with chunk 4 (these two with a
   NaN, an inf and a zero chunk), ``dequant_sum_int8`` also on its char4
   and byte loads (rows of 4100, codes 4 and 1 bytes off a 16-byte
   boundary), ``quant_int8``'s two forms (every chunk of its first form at
   one 4 MB bucket's shape, rows cut to a multiple of the chunk; the bucket
   4 bytes off 16-byte alignment and chunk 12 in its general form) and ``dequant_int8``'s three load widths,
   the forms ``quant_twobit`` (q, dq and the stage-1 error) and
   ``dequant_sum_twobit`` pick (TWOBIT_FORM_CASES: a 4 MB bucket,
   ResNet-50's gradient with its odd row of code bytes, dp_overlap's
   odd-B bucket, rows 0, 8 and 1 floats off a 16-byte boundary, codes 0,
   8, 1 and 3 bytes off, tails; every output poisoned first), checks that
   two launches agree bitwise,
   and times each at the two-rank exchange's shapes beside its bound, its
   plain version and the codec path's torch composition (``quant_twobit``
   with its error, as the exchange runs it);
10. dp_train: two rank processes (forked, gloo through pinned host buffers)
   share the card and train the full-width ResNet-50 (batch 32 a rank) for
   8 steps through ``FeedForward(ctx=gpu(0), optimizer="adam",
   fused=True).fit(kvstore="dist_sync", compression=..., comm_kernels=True)``
   with int8 and then twobit; checks the launches per step per rank, the
   wire bytes against ``allreduce_plan``, that both ranks' parameters are
   bitwise equal (from different initial weights: rank 0's broadcast), that
   each rank's loss fell, and that the card's sync is bitwise the same
   exchange run on a CPU copy of the flat gradient buffer; prints the step
   time, global images per second, one step's forward / backward / sync /
   update split and the sync's kernel, host-transfer and gloo time and the
   time of the gradient buffer's views (the gradients are views of one
   flat buffer that backward accumulates into, the residual add included);
10a. dp_overlap: dp_train's two ranks, model and batch, 6 steps of
   ``fit(..., overlap=4 MB)``: the gradient exchanged bucket by bucket on a
   side stream as soon as backward has filled each bucket; checks the
   comm kernels' launches per step (DP_LAUNCHES x the buckets, fused_adam
   once), the wire bytes against ``comm.stats.overlap_plan``, each bucket's
   synced gradients and residual on the card bitwise the CPU exchange of
   the same bucket, both ranks' parameters bitwise equal and the loss
   falling; prints the step against dp_train's fused step and
   ``overlap_efficiency`` from the step, its compute alone and its
   exchange alone (the ranks share the card: overlap's gain cannot show);
   the comm kernels are also timed at one bucket's shape (1,048,576
   elements over 2 ranks) after phase comm_kernels, beside an empty
   launch (``torch.cuda._sleep(0)``) timed alike, the launch floor; the
   twobit kernels in the forms their wrappers pick at TWOBIT_SHAPES; and
   the stage-1 ``quant_twobit`` of all 31 buckets back to back between
   one event pair, beside 31 empty launches timed alike and each bucket
   alone;
10b. dp_async: ResNet-50 (batch 32, f32, SGD) through
   ``fit(kvstore="dist_async")``: one worker, whose final weights must be
   bitwise the host's updates replayed over the gradients it pushed; the
   same in stale sync (``overlap=True``), each step getting the previous
   round's weights and ``flush_stale`` the last; two workers sharing the
   card with int8 pushes (the host applied 2 x 4 pushes, the codecs' sent
   bytes are its received bytes); the loss falling; prints the step, its
   device time and the round trip's copy to the host, push_pull and copy
   back;
10c. ctx_list: a list of devices in one process: the replicas' exchange
   (``comm.ReplicaGroup``, one member a replica, all on the card) of 2
   and of 4 replicas' rows at ResNet-50's gradient and at one 4 MB bucket,
   int8 and twobit, with error feedback: the comm kernels' launches of
   each exchange (DP_LAUNCHES x the replicas), each replica's result and
   residual bitwise the same exchange through the kernels' plain versions
   on the card, and for 2 replicas bitwise the two gloo ranks' exchange of
   the same rows (two rank processes sharing the card); the in-process
   and the gloo exchange's ms; ``FeedForward(ctx=[gpu(0), gpu(1)])`` on
   the one card: one replica after aliases are removed, captured, its fit
   bitwise the ``ctx=gpu(0)`` fit;
10d. comm_table: dp_overlap's two ranks, model and batch, 2 steps of
   ``fit(..., overlap=4 MB, comm_kernels=True)`` in int8 and twobit under
   ``torch.profiler`` (every thread recorded: the schedule's comm thread
   issues the buckets): the profiled collective table
   (``comm.collective_table``) equal to ``comm.overlap_plan`` x 2 in
   payload and wire bytes, op by op; a ``Monitor(track_comm=True)``'s
   ``comm/*`` rows equal to the registry's delta; the largest bucket's
   exchange alone runs no slab-sized quantize pass as a torch operation
   with the kernels (``comm.quantize_pass_count``: 0) and some with the
   codec;
10e. verify: full-width ResNet-50 at batch 32 bound for training on the
   card in f32 and bf16 with ``MXNET_TPU_VERIFY`` on and off: the median
   host ms of a bind each way and of ``Symbol.verify`` alone, and its
   share of one captured training step (forward and backward replayed);
   a seeded shape conflict raises MX402 naming its node;
10f. program_audit: ``analysis.audit_executor`` of the bf16 training
   executor: its findings (rule, node, range) those of the same graph on
   the CPU, its contraction FLOPs a ``FlopCounter``'s, a ``_Native`` node
   one MX501; the launches and host seconds around it;
10g. shard_audit: comm_table's two ranks, int8 and twobit, each fit of 2
   steps without and then with ``shard_audit=True``: each audited fit
   trains with one clean report (matched rows, BatchNorm's averaged
   statistics a planned row, int8's codes and scales a named note of
   twice the plan's collectives at the plan's bytes), and a twobit fit
   held to int8's plan raises MX802 with the parameters bitwise rank 0's
   initial ones; prints what the audit adds to a fit and each rank's
   launches;
11. lm_mesh: two rank processes (forked, gloo through pinned host buffers)
   share the card and train the full-width transformer LM (global batch 8
   x 2048 tokens, bf16) for 4 steps each through ``make_train_step(mesh,
   optimizer=Adam(fused=True))`` on a mesh of sp = 2 (ring flash attention:
   1024 tokens a rank) and one of tp = 2 (4 heads and half the vocab a
   rank); checks the launches per step per rank (on sp = 2 rank 0 runs one
   flash call of each kind a layer and rank 1 two), that the first step's
   loss is the single-rank step's within 1e-5 relative and each rank's
   logits block within 2e-2 (relative Frobenius), and that three planted
   faults each read above both bounds, that the loss fell and the
   parameters are finite and moved, that the replicated leaves are bitwise
   equal across the ranks; holds ring flash attention alone at sp = 2
   (the output and dq, dk, dv) against the f32 reference row by row (dq
   and dk given the ring's output); prints
   the step time, global tokens per second and one step's forward /
   backward / gradient sum / update split per rank with the gloo time;
12. moe_mesh: four rank processes (forked, gloo through pinned host
   buffers) share the card and train the MoE pipeline LM (vocab 32000,
   d_model 512, 8 heads, d_ff 2048, 8 experts, one block on each of 2
   stages, 4 microbatches, f32, seeded random weights, Zipf-distributed
   token ids) on dp 1 x pp 2 x ep 2 for 4 steps of ``make_train_step(mesh,
   lr=0.1, momentum=0.9)``; checks the first step's loss against a
   yardstick written here (one process: each shard's microbatches through
   stage 0 then stage 1, every expert local) within MOE_LOSS_BOUND, and
   the second step's against the yardstick's after one SGD step of its own
   autograd gradient within MOE_STEP_BOUND, each also bitwise the loss read
   apart; that four planted forward faults each read above the first bound
   and two planted backward faults above the second; that the loss is finite,
   the parameters moved, the replicated blocks are bitwise equal across
   the ranks and no hand-written kernel launched; prints the routing's
   agreement with the yardstick, the step time, global tokens per second
   and one step's forward / backward / gradient sum / update split per
   rank with the gloo time;
12a. mxlint: the linted source run on the card. The timing fixture (20
   replays of fused_adam captured at ResNet-50's 161 leaves, the clock read
   after the loop) is flagged by the port's ``lint_source`` with exactly
   MX306, and its copy that calls ``torch.cuda.synchronize()`` before the
   read is not; on the card the flagged copy reads at most half the clean
   one, and the clean one at least 20 x PERF.md's row time x MXLINT_FLOOR.
   The capture fixture (a step that calls ``.item()``, given to
   ``utils.compile.CapturedProgram``) is flagged with exactly MX202, and its
   capture raises on the card; its copy that returns the tensor is not
   flagged, captures and replays the right sum. Then ``python -m
   mxnet_tpu_torch.analysis --all`` (the source lint and the concurrency
   lint of the port's tree, and the sharding audit over eight CPU
   replicas), which phase card ran beside the builds, exited 0; prints its
   seconds and file count;
12b. bindings: (a) ResNet-50 (batch 32, f32, TF32 off, cuDNN
   deterministic) trained CAPI_STEPS steps through the flat C API loaded
   with ctypes: the symbol from MXSymbolCreateFromJSON, every argument made
   by MXNDArrayCreate(dev_type=2) and MXNDArraySyncCopyFromCPU,
   MXExecutorBind(dev_type=2) with each of the 161 parameters' gradients
   written, MXExecutorForward(1), MXExecutorBackward and SGD through
   MXFuncInvoke; each step's output and gradients (MXNDArraySyncCopyToCPU)
   held to the port's Python ``Executor`` on gpu(0) over the same
   arguments within CAPI_BOUND (relative Frobenius; bitwise expected);
   MXNDArrayGetContext reads (2, 0) for an argument and an output; a
   planted stale-handle fault (a rebound handle not copied into the
   executor) reads above the bound and a one-ulp change of one weight is
   not bitwise equal; a KVStore's C updater calls back into MX* on card
   arrays. (b) tests/torch_capi_host.cc, a C program linked against the
   library, embeds Python and trains the MLP on dev_type 2 for
   CAPI_MLP_STEPS SGD steps: it exits 0, its loss falls and its first loss
   equals the same sequence's run here through ctypes (under the package's
   default precision, TF32 on, which the host's process keeps). (c) ResNet-50 at
   batch 1 exported by the port's ``Predictor`` on the card runs through
   the native predictor, the amalgamated build and the standalone module
   on this machine's CPU: bitwise equal to each other and within
   PREDICT_TOL of the card's output. Prints each path's host ms a step or
   a request (the predictor's: CPU time of the card's machine), the build
   seconds (phase card's, beside nvcc), and the phase's seconds against
   its 120 s budget;
12c. tools_examples: the port's tools and launched examples
   (``mxnet_tpu_torch.tools``, ``mxnet_tpu_torch.examples``; see
   ``phase_tools_examples``): the repo's ``tools/launch.py -n 2`` running
   the dist_sync MLP example on the card (two workers sharing it over
   gloo, the kvstore's backend choice), ``elastic_train`` over ``[gpu(0)]
   * 8`` (rows 3, 5, 7 launched and held bitwise at its bucket shapes),
   ``train_long_lm --dp 2 --sp 2 --flash`` on four ranks (its loss
   assertion, the flash launches derived from steps, layers and ring
   blocks, the kernels held row by row at its shape), ``im2rec`` on the
   card's host (the JAX script's bytes, read back through
   ``ImageRecordIter``) and the Caffe converter (its LeNet on the card
   against the CPU); prints the phase's seconds against its 100 s budget;
12d. examples: the port's fifteen single-process examples (``mxnet_tpu_
   torch.examples.{mnist,cifar10,imagenet,rnn,notebooks,numpy_ops,
   python_howto,adversary,memcost}``; see ``phase_examples``), each run in
   this process through its ``main(argv)`` at the JAX script's default
   arguments (ResNet-50 at batch 128 on the 512 synthetic 256x256 JPEGs,
   Inception-BN at batch 128 on 2,048 CIFAR records, the LSTMs at their
   widths), on the card: each script's own assertions and printed lines,
   its peak card bytes above what the card held before it, the synthetic
   data's sha256 the JAX functions', and ``lstm_bucketing`` under the
   package's gate ``MXNET_TPU_FUSED_ADAM=1``: fused_adam launched once a
   batch (the count derived from its corpus), counted by the wrapper and
   in a ``torch.profiler`` trace, and its first launch's inputs held
   bitwise against ``fused_adam_step_plain``; prints each script's
   seconds and the phase's against its 150 s budget;
12e. bench_tools: the six measurement tools (``mxnet_tpu_torch.tools.
   {bench_flash,bench_longctx,bench_mnist,bench_roofline,
   scaling_projection,bench_io_scaling}``; see ``phase_bench_tools``),
   each through its ``main(argv)`` in this process at full width, only
   repeat counts cut, its JSON in the phase's directory: each names the
   card as nvidia-smi does, bench_flash ran every configuration, its
   LM-shape flash_fwd within 15% of phase flash's time and its launches
   what its sweep derives, no bf16 rate above the measured bf16 GEMM rate
   and no f32 rate above the card's f32 rate, the roofline's step no
   faster than its own traffic's floor, bench_longctx a row a sequence and
   remat, and at most 1 GiB left allocated by the earlier phases as it
   starts; prints each tool's seconds and the phase's against its 150 s
   budget, and fails past it;
12f. bench_subsystems: bench.py's thirteen subsystem benches
   (``mxnet_tpu_torch.tools.bench_<name>``; see
   ``phase_bench_subsystems``), each through its ``main(argv)`` in this
   process at full size (bench_compile's four children in processes of
   their own), no count cut, eight replicas time-sharing the card where
   the JAX benches run a dp-8 mesh: each JSON names the card as
   nvidia-smi does; each bench's ``check`` holds (no lock-order cycle, the
   health detectors' latencies, rank 7 evicted and rank 6 backfilled,
   worlds [6, 8] and [3, 4], recovery tiers t1 and t2, wire bytes the
   plan's, bucket plans summing to the fused plan, the kernel path with
   no slab-sized quantize pass, fused_adam bitwise, coverage of at least
   80%, a memory plan recorded by bench_mem's own capture, the cold
   child's kernel build and none in the warm child);
   bench_kernels launches every kernel; the JAX overhead bounds are
   printed with each headline, met or missed; prints each bench's
   seconds and the phase's against its 300 s budget, and fails past it;
13. prints one line ``{"kernels": [...]}`` with each kernel's launches on its
   main path, error, times and bound (the flash kernels and fused_adam also
   their launches in lm_mesh; fused_adam its launches in train_bf16 and zoo;
   every kernel its launches in moe_mesh, 0, in each of phases 5f-5i,
   read around that phase's main path, and in phases 5j and 5k, counted by
   replay; ``slice12_launches``: the captured remat fits of 5a and 5c, by
   replay, and 5l's fit from the JPEG shard; ``slice13_launches``: 5m's
   epoch, 10a's fits and 10b's one-worker fit; ``slice14_launches``: 5n's
   epoch; ``slice16_launches``: lm_graphs' captured run, by replay, and
   ctx_list's exchanges; ``slice17_launches``: 5o's observed fit (its
   counted step, warm-up, replays and window steps);
   ``slice19_launches``: 5p's first guarded fit, by replay, and 10d's
   profiled fits (rank 0, both modes); ``slice20_launches``: 5q's elastic
   fit over its three worlds and 5r's first fit (eager replicas);
   ``slice21_launches``: 10e's binds, 10f's audit and 10g's audited fits
   (rank 0, both modes, the audit's step included);
   ``slice22_launches``: 12a's timing fixtures (120 replays of the
   captured fused_adam step: each copy three times, 20 a time);
   ``slice23_launches``: 12b's C API steps, embedded host and native
   predictor (0: no hand-written kernel on that path);
   ``slice24_launches``: 12c's elastic fit, the four train_long_lm ranks
   summed and the tools (the launched workers count in their own
   processes); ``slice25_launches``: 12d's fifteen scripts, each read
   around its own run; ``slice26_launches``: 12e's six tools, each read
   around its own run; ``slice27_launches``: 12f's thirteen benches, each
   read around its own run; rows
   3-7 also their times, bound, library time
   and the launch floor at one bucket's shape and their launches on the
   overlap path, ``bucket_shape``);
14. ends with ``{"ok": true, "device": {...}}``.

Under the port's default, every single-card ``FeedForward`` fit above
replays captured steps (phases train, train_bf16, zoo, io_fit, io_native,
graphs, ckpt; remat fits too since slice 12), and launches are counted by
replay. Since slice 16 so do ``Module.fit`` and ``BucketingModule.fit``
(lstm_bucketing: one pair of graphs a bucket) and the LM's
``make_train_step`` without a mesh (lm_train, lm_graphs); mesh steps
(lm_mesh, moe_mesh) stay eager.

Every phase that holds the card to a reference runs with
``set_matmul_precision("highest")`` (f32 contractions, TF32 off); the
slice 9 phases time ``"default"`` (TF32) beside it. Any failed check
raises, and the script exits non-zero without the last line. Without CUDA
it exits non-zero at once. It imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
BATCH = 32
IMAGE = (3, 224, 224)
REQUESTS = 8
# (M, K, N): ResNet-50 fc1 at batch 32 and at batch 1, the JAX package's own
# ragged test shape, and a large square-ish product
KERNEL_SHAPES = ((32, 2048, 1000), (1, 2048, 1000), (37, 100, 23),
                 (256, 4096, 4096))
MAIN_SHAPE = KERNEL_SHAPES[0]
KERNEL_SOURCES = ("int8_matmul", "fused_adam", "flash_attention",
                  "comm_kernels")
TRAIN_STEPS = 8
LEARNING_RATE = 1e-3
# slice 9: bf16 compute_dtype, remat, the zoo, the imperative NDArray and
# Monitor. Remat boundaries: the reference's own example for the ResNet
# (mxnet_tpu/executor.py:125); for AlexNet one after each LRN and one after
# the last Dropout, so both Dropouts are recomputed in the backward.
REMAT_PATTERN = r"unit\d+_out$"
ALEXNET_REMAT = r"norm\d$|drop2$"
ZOO_STEPS = 6
# bf16 against f32 ("highest") on the same weights and batch, one training
# forward of ResNet-50: the loss per image, relative, and the centred
# log-probabilities, relative Frobenius. A CPU rehearsal at batch 4 read
# 6.1e-4 and 7.8e-3; the planted bf16 softmax (its sum carried in bf16)
# read 7.0e-2 on the loss, and BatchNorm statistics taken in bf16 1.3e-3 and
# 1.3e-2 (within both bounds: torch's reductions carry f32 sums even for
# bf16 inputs, so that fault only rounds the statistics).
BF16_LOSS_BOUND = 5e-3
BF16_LOGITS_BOUND = 3e-2
# remat against the plain bf16 fit: the parameters' update after 8 steps,
# relative Frobenius over all leaves, and AlexNet's gradients per leaf after
# one step from the same generator state (cuDNN's backward is not bitwise
# run to run; a recompute with other Dropout masks moves fc1's and fc2's
# gradients by O(1))
REMAT_UPDATE_BOUND = 5e-2
ZOO_REMAT_GRAD_BOUND = 5e-2
# remat's tape on the card (zoo): an MLP with a Dropout after each layer
# and a remat boundary after each Dropout, one training forward and
# backward in f32; 64 MiB an activation, small weights (made on the host)
REMAT_MLP = dict(batch=8192, hidden=2048, layers=8)
REMAT_MLP_PATTERN = r"drop\d+$"
ND_SHAPE = (4096, 4096)
MONITOR_PATTERN = r".*unit\d+_out_output$"
MONITOR_STEPS = 2
# tests/test_pallas_kernels.py:259, the JAX package's own odd leaf set
ODD_SHAPES = {"w1": (64, 33), "b1": (33,), "w2": (7, 5), "s": ()}
# the transformer LM: batch x sequence of the full-width runs, requests
# served, training steps, and the cut (batch, sequence) of card-vs-CPU checks
LM_BATCH, LM_SEQ = 8, 2048
LM_REQUESTS = 5
LM_STEPS = 8
LM_CUT = (1, 256)
# the sharded LM: two ranks sharing the card, the meshes, steps, time limit
LM_MESH_WORLD = 2
LM_MESHES = {"sp2": {"sp": 2}, "tp2": {"tp": 2}}
LM_MESH_STEPS = 4
LM_MESH_TIMEOUT_S = 600
# The first step on a mesh against the single-rank step from the same
# parameters and tokens: the loss (a mean over 16,384 tokens of an f32
# log-softmax), relative, and each rank's block of the logits, relative
# Frobenius. Both are bf16 models: on sp = 2 the ring rounds each hop's
# attention output to bf16 before the f32 merge and rounds the merge again
# (once on one card); on tp = 2 the row-parallel products sum over tp in f32
# in another order before their one rounding. Sound, these read (H100):
# loss 1.2e-6 (sp = 2) and 2.1e-6 (tp = 2), logits 7.0e-3 (sp = 2, rank 1;
# rank 0's block is bitwise) and 5.4e-3 (tp = 2). With one fault planted at
# a time (lm_mesh_faults), each gated to read above both bounds, the
# smallest readings were pos_embed from row 0 on sp = 2, loss 2.4e-5 and
# logits 5.0e-2; the others read loss 1.7e-4 and up, logits 0.23 and up.
# Each bound sits between: 3-8 times the sound readings, 2.4-2.5 times
# below the smallest fault's. The loss alone, a mean near log(32000),
# moves little under an attention fault.
LM_MESH_LOSS_BOUND = 1e-5
LM_MESH_LOGITS_BOUND = 2e-2
# the MoE pipeline LM: four ranks sharing the card on dp 1 x pp 2 x ep 2
# (the dryrun's second mesh at dp = 1); the LM's widths with Switch's 8
# experts, depth the pp size (one block a stage); the global batch of the LM
# phases, so a (dp, ep) shard holds 4 sequences, one a microbatch
MOE_MESH_WORLD = 4
MOE_MESH = {"pp": 2, "ep": 2}
MOE_CONFIG = dict(vocab_size=32000, d_model=512, n_heads=8, d_ff=2048,
                  n_experts=8, max_len=2048, n_micro=4, capacity_factor=2.0,
                  aux_loss_coef=0.01)
MOE_STEPS = 4
MOE_LR, MOE_MOMENTUM = 0.1, 0.9
MOE_MESH_TIMEOUT_S = 600
# token ids drawn with Zipf frequencies, as text's are: top-1 routing then
# overflows some experts' capacity at capacity factor 2, so that the drop
# path runs (with uniform ids every expert gets about 256 of its 512 slots)
MOE_ZIPF = 1.2
# The first step's loss on the mesh against the yardstick (one process, the
# same model written apart, relative): f32 throughout, so only the order of
# the sums differs. Sound, it read 1.4e-8 and 0.0 (H100); with one fault
# planted at a time (moe_mesh_faults), 5.0e-4 (the aux unmasked at the bubble
# ticks), 6.8e-4 (capacity over the global tokens), 2.4e-3 (the inverse route
# untransposed) and 2.3e-2 (the stages reversed). The bound sits 70 times
# above the larger sound reading and 500 times below the smallest fault's;
# each fault is gated to read above it.
MOE_LOSS_BOUND = 1e-6
# The second step's loss against the yardstick's after one SGD step of its
# own autograd gradient (relative): the update amplifies the rounding of the
# sound step's gradient, which read 5.5e-8 (H100); a step taken with the
# dispatch all-to-all's gradient rows permuted read 3.6e-3, with the stage
# gradients not summed over ep 9.3e-3. The bound sits 180 times above the
# sound reading and 360 times below the smaller fault's.
MOE_STEP_BOUND = 1e-5
# (q shape, dtype, causal, seq_k or None for seq_q): the LM's attention, a
# non-causal shape, the JAX package's ragged tail test (tests/test_pallas.py
# :35), and the Hopper kernels' edges at small size: head_dim 32 and 40
# (TMA's zero fill), 128 (two boxes a row), sequences of 77 and 1000 (a
# multiple of neither the 64-row tile nor the 128-row block), seq_q != seq_k,
# and batch x heads 65,536 (past gridDim.y's 65,535: one linear grid); then
# the forms bench_flash times at 16,384 (phase bench_tools), at its batch x
# heads of 4 and 2,048 rows: the f32 SIMT kernels at head_dim 64 and 128,
# causal and not, and bf16 causal at 128
FLASH_CASES = (((LM_BATCH, 8, LM_SEQ, 64), "bfloat16", True, None),
               ((4, 8, 1024, 64), "bfloat16", False, None),
               ((1, 2, 48, 24), "float32", True, None),
               ((2, 2, 77, 32), "bfloat16", True, None),
               ((1, 3, 1000, 40), "bfloat16", True, None),
               ((2, 2, 1000, 128), "bfloat16", False, None),
               ((1, 2, 300, 128), "bfloat16", False, 77),
               ((2, 2, 100, 64), "bfloat16", False, 300),
               ((65536, 1, 16, 64), "bfloat16", True, None),
               # the ring's blocks at sp = 2: the diagonal (views of one
               # packed qkv) and the off-diagonal block, whose k and v are
               # fresh contiguous tensors received from the other rank
               ((LM_BATCH, 8, LM_SEQ // 2, 64), "bfloat16", True, None),
               ((LM_BATCH, 8, LM_SEQ // 2, 64), "bfloat16", False,
                LM_SEQ // 2),
               # a rank's attention at tp = 2: half the heads, views of its
               # packed (b, s, 3, h / tp, d) qkv
               ((LM_BATCH, 8 // LM_MESH_WORLD, LM_SEQ, 64), "bfloat16", True,
                None),
               *(((1, 4, 2048, d), "float32", causal, None)
                 for d in (64, 128) for causal in (False, True)),
               ((1, 4, 2048, 128), "bfloat16", True, None))
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# data-parallel training: ranks sharing the card, steps, modes, time limit
DP_WORLD = 2
DP_STEPS = 8
DP_MODES = ("int8", "twobit")
DP_TIMEOUT_S = 600
# launches per step per rank on the dp_train path, by mode (the rest: 0)
DP_LAUNCHES = {
    "int8": {"quant_int8": 2, "dequant_sum_int8": 1, "dequant_int8": 1,
             "fused_adam": 1},
    "twobit": {"quant_twobit": 1, "dequant_sum_twobit": 1, "fused_adam": 1},
}
# ResNet-50's gradient: 161 leaves, 25,557,032 elements; int8 chunk
RESNET50_GRAD = 25_557_032
COMM_CHUNK = 256
# slice 13. dp_overlap: dp_train's ranks, model and batch with the gradient
# exchanged bucket by bucket while backward runs (4 MB buckets); the comm
# kernels timed at one bucket's shape too
DP_OVERLAP_STEPS = 6
DP_OVERLAP_BUCKET_BYTES = 4 << 20
BUCKET_ELEMS = DP_OVERLAP_BUCKET_BYTES // 4
# slice 16. ctx_list: the in-process exchange of a ctx list's replicas, at
# ResNet-50's gradient and one 4 MB bucket, against the plain versions and
# against the two gloo ranks; a ctx list of two cards aliased on one card
CTX_REPLICAS = (2, 4)
CTX_SIZES = {"resnet50_grad": RESNET50_GRAD, "bucket": BUCKET_ELEMS}
CTX_REPS = 5
CTX_TIMEOUT_S = 300
CTX_FIT_STEPS = 4
CTX_FIT_BATCH = 64
# lm_graphs: the full-width LM's step captured against eager; the executor
# pair of graphs; Module.fit captured
LM_GRAPH_STEPS = 8
EXE_STEPS = 3
MODULE_STEPS = 8
# slice 14: quant_int8's forms and dequant_int8's load widths on the card,
# (shape, chunk, offset of the rows in floats past a 16-byte boundary)
INT8_FORM_CASES = (
    [((2, BUCKET_ELEMS // 2 // c * c), c, 0) for c in range(128, 1025, 128)]
    + [((2, BUCKET_ELEMS // 2), COMM_CHUNK, 1), ((3, 1212), 12, 0),
       ((3, 1212), 12, 3)])
# quant_twobit's two forms and dequant_sum_twobit's two load widths. The
# three shapes they are timed at: one 4 MB bucket,
# ResNet-50's gradient over two ranks (25,557,032 is a multiple of the
# twobit unit times the ranks: a row of 3,194,629 code bytes, odd) and
# dp_overlap's one bucket with an odd B (5,096 elements: B = 637)
TWOBIT_SHAPES = {"4 MB bucket": (2, BUCKET_ELEMS // 2),
                 "ResNet-50 gradient": (2, RESNET50_GRAD // 2),
                 "odd-B bucket": (2, 2548)}
# parity: those shapes with rows 0, 8 and 1 floats past a 16-byte boundary
# (a bucket view starts at a multiple of 8), and tails of 4, 8 and 12
# elements past a multiple of 16
TWOBIT_FORM_CASES = (
    [(shape, off) for shape in TWOBIT_SHAPES.values() for off in (0, 8, 1)]
    + [((1, 16 * k + t), 0) for k in (0, 33) for t in (4, 8, 12)])
# the stream's hold before a timed series of 31 launches: long enough for
# the host to queue them all
SERIES_SPIN = 40_000_000
# dp_async: ResNet-50 at batch 32, f32, through fit(kvstore="dist_async"):
# one worker (SGD; its weights replayed on the host), two workers sharing
# the card (int8 pushes), one worker in stale sync (overlap=True)
DP_ASYNC_STEPS = 4
DP_ASYNC_WORLD = 2
DP_ASYNC_OPT = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9)
DP_ASYNC_TIMEOUT_S = 600
# native_progressive: records of the PNG shard re-encoded by PIL as
# progressive JPEG; a shard of the first PROGRESSIVE_RECORDS records,
# baseline up to PROGRESSIVE_FIRST and every other one progressive after
PROGRESSIVE_SAMPLE = 16
PROGRESSIVE_RECORDS = 256
PROGRESSIVE_FIRST = 64


# slice 10, the data path. io_feed / io_fit: a RecordIO shard of PNG
# records (the port's own PNG codec; phase io_native re-encodes the same
# images as JPEG), smooth gradients like
# the JAX package's io bench shard (bench.py:240-262) with sides drawn from
# 256-480 so that resize=256 resamples, read with bench.py:266-273's
# iterator settings; io_fit trains bf16 ResNet-50 from it with bench.py's
# SGD (run_io_bench, bench.py:339-341)
IO_DIR = "build/chip_smoke/io"
IO_RECORDS = 512
IO_SIDES = (256, 481)
IO_ITER = dict(data_shape=(3, 224, 224), batch_size=32, shuffle=True,
               rand_crop=True, rand_mirror=True, resize=256,
               prefetch_buffer=8, seed=7, output_dtype="uint8")
IO_EPOCH_STEPS = IO_RECORDS // IO_ITER["batch_size"]
IO_LR, IO_MOMENTUM = 0.01, 0.9
# slice 12, io_native: the same images as JPEG records (the port's codec at
# pack_img's quality 95, 4:2:0, which writes PIL's bytes) through the
# native pipeline. The fits of a whole epoch at IO_ITER's settings (io_fit's
# from the PNG shard, io_native's from the JPEG shard and the cached
# batch) read steps 13-16, by which the 8 prefetched batches and those
# decoded during the warm-up and capture steps are spent, so that they read
# the steady state, the decode threads busy; they are the thread sweep's
# row at the host's cores (8 on the card's machine). The sweep's rows
# below the cores train half the shard (num_parts 2, 8 steps) with as
# many prefetched batches as threads, spent by step 4, and read steps
# 5-8: both routes decode a batch a task (an engine task, a ticket) and
# start no more than the prefetch depth, so a shallower one idles
# threads. Feed-only rates are read at IO_THREADS
IO_THREADS = (1, 2, 4, 8)
IO_STEADY_WINDOW = (12, 16)
IO_SWEEP_THREADS = (1, 2, 4)
IO_SWEEP_PARTS = 2
IO_SWEEP_WINDOW = (4, 8)
# the profiler reads this many steps of a window: its trace of a
# captured ResNet-50 step holds hundreds of kernels, and stopping it on a
# longer one holds the host for seconds
IO_PROFILE_STEPS = 4
IO_JPEG_QUALITY = 95
# the native codec against PIL (which the card's machine has) on sampled
# records: PIL's encode gives the same bytes and PIL's decode the same
# pixels, exactly (the JAX package's own test bound is 1,
# tests/test_native.py:66). Against the source pixels JPEG's loss at
# quality 95 reads up to about 16, 0.6-0.9 on average: a mean bound that a
# wrong decode (shifted blocks, swapped planes) lands far above
IO_SOURCE_MEAN_BOUND = 2.0
# lstm_bucketing / lstm_scan: the widths of MXNet's PTB bucketing example
# (example/rnn/lstm_bucketing.py: 2 layers of 200, embedding 200, buckets
# 10-60, batch 32, SGD lr 0.5 on the batch mean) over a synthetic corpus
# (Zipf ids, lengths 5-60; the repository holds no PTB text), vocabulary
# 10,000 as PTB's
LSTM_CONFIG = dict(num_layers=2, num_hidden=200, num_embed=200, vocab=10000)
LSTM_BUCKETS = [10, 20, 30, 40, 50, 60]
LSTM_BATCH = 32
LSTM_OPT = {"learning_rate": 0.5, "rescale_grad": 1 / LSTM_BATCH}
LSTM_SENTENCES = 768
# the corpus of the LSTM fits of phases graphs and ckpt, drawn as the one
# above: 13 steps an epoch, every bucket in it
LSTM_GRAPH_SENTENCES = 320
LSTM_LENGTHS = (5, 60)
LSTM_ZIPF = 1.2
# the card's first-step loss (a mean NLL near log(10000)) against the same
# step on the CPU, relative: f32 throughout, only summation orders differ
LSTM_CPU_BOUND = 1e-5
GRAPH_STEPS = 8
# ckpt's ResNet-50 fits: snapshots after steps 2, 4 and 6, killed after 5
CKPT_STEPS = 6
LSTM_SCAN_SEQ = 64
LSTM_SCAN_STEPS = 8
LSTM_SCAN_LR = 0.5
# LSTMLM's logits on the card against the CPU's, max abs (logits of order 1)
LSTM_SCAN_LOGIT_BOUND = 1e-4


_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's row also carries the seconds since the
    script started (``at_s``)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=25, spin=2_000_000):
    """Median device time of ``fn`` over ``reps`` calls, each after a flush
    of the 50 MB L2 cache and a spin of ``spin`` clock cycles that holds the
    stream until the host has queued the timed region, so that host launch
    cost stays out."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def card_device_us(torch, prof):
    """The card's busy microseconds in a ``torch.profiler`` trace: the
    durations of its kernels, copies and sets, summed as the tracer hands
    them over. ``key_averages`` gives the same sum, but it first builds a
    table of every event, which on a trace of tens of thousands of kernels
    costs tens of seconds on the host."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()
               ) / 1e3


def card_report(torch, run_once, repeats, unit):
    """Wall and device ms per call of ``run_once`` over ``repeats`` calls
    under ``torch.profiler`` (the card's activity only) and the card's idle
    share of that window."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            run_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_us = card_device_us(torch, prof)
    require(device_us > 0, "the profiler recorded the card's activity")
    return {f"wall_ms_per_{unit}": wall_us / repeats / 1e3,
            f"device_ms_per_{unit}": device_us / repeats / 1e3,
            "device_idle_share": 1.0 - device_us / wall_us}


def centered_logits(p):
    """Log-probabilities less their row mean: the logits up to a per-row
    constant, which the softmax output determines."""
    lp = np.log(p.astype(np.float64))
    return lp - lp.mean(axis=1, keepdims=True)


def rel_fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def start_logged(cmd, out_dir, name, cwd=None, env=None):
    """``cmd`` in the background (in ``env``, else this process's), its
    output in files under ``out_dir`` (a full pipe cannot stall it); what
    :func:`finish_logged` takes."""
    import os

    files = [open(os.path.join(out_dir, f"{name}.{ext}"), "w+")
             for ext in ("out", "err")]
    proc = subprocess.Popen(cmd, stdout=files[0], stderr=files[1], cwd=cwd,
                            env=env)
    return proc, files, time.perf_counter()


def finish_logged(started, timeout_s):
    """(exit code, stdout, stderr, seconds) of a :func:`start_logged`
    process; killed past ``timeout_s`` from its start."""
    proc, files, t0 = started
    try:
        proc.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    text = []
    for f in files:
        f.seek(0)
        text.append(f.read())
        f.close()
    return proc.returncode, text[0], text[1], seconds


def start_mxlint_cli():
    """The lint's CLI over the port's tree with every pass, started in the
    background (a CPU process that touches no card), and killed at exit if
    the run ends before :func:`finish_mxlint_cli`. Returns what that
    takes: the started process and its seconds once it ends."""
    import atexit
    import os
    import threading

    repo = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(repo, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    started = start_logged([sys.executable, "-m", "mxnet_tpu_torch.analysis",
                            "--all"], out_dir, "mxlint_cli", cwd=repo)
    proc, ended = started[0], {}

    def wait():
        proc.wait()
        ended["seconds"] = time.perf_counter() - started[2]

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    threading.Thread(target=wait, daemon=True).start()
    atexit.register(stop)
    return started, ended


def finish_mxlint_cli(started):
    """(exit code, stdout, stderr, seconds it ran) of the CLI that
    :func:`start_mxlint_cli` started; killed past MXLINT_CLI_TIMEOUT_S."""
    started, ended = started
    rc, out, err, seconds = finish_logged(started, MXLINT_CLI_TIMEOUT_S)
    return rc, out, err, ended.get("seconds", seconds)


def phase_card(torch, common):
    """The card's name and power limit, then every build of the run at
    once: nvcc for each kernel source, the host compiler for the native
    data pipeline and for the bindings' libraries, and the lint's CLI
    beside them, left running beside the phases that follow until phase
    mxlint reads its result. Returns the nvidia-smi line, what
    :func:`finish_mxlint_cli` takes and the bindings' builds."""
    from pathlib import Path

    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    t0 = time.perf_counter()
    cli = start_mxlint_cli()

    def build(stem):
        common.load_library(stem)
        return time.perf_counter() - t0

    def build_native():
        from mxnet_tpu_torch import native

        native.require_lib()
        return time.perf_counter() - t0

    # nvcc on a fresh checkout: one compiler per source, all at once, and
    # the host compiler for the native data pipeline and the bindings
    # beside them
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 2) as pool:
        native_s = pool.submit(build_native)
        bindings = pool.submit(bindings_builds, Path(BINDINGS_DIR))
        library_s = dict(zip(KERNEL_SOURCES,
                             pool.map(build, KERNEL_SOURCES)))
        library_s["mxtpu_native (g++)"] = native_s.result()
        bindings = bindings.result()
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels_loaded": list(KERNEL_SOURCES), "build_s": build_s,
          # each library's build, from the common start (they run at once)
          "library_build_s": library_s, "bindings_build_s": bindings[3]})
    return smi, cli, bindings


def phase_kernels(torch, k8, registry):
    """int8_matmul against its plain version, and its times."""
    rng = np.random.default_rng(SEED)
    rows, max_err = [], 0.0
    for M, K, N in KERNEL_SHAPES:
        x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).cuda()
        w = torch.from_numpy(rng.standard_normal((N, K), np.float32)).cuda()
        wq, sw = k8.quantize_channels(w)
        plain = k8.int8_matmul_plain(x, wq, sw)
        y_float_w = k8.int8_matmul(x, w)
        y_prequant = k8.int8_matmul(x, wq, w_scale=sw)
        torch.cuda.synchronize()
        err = max(float((y_float_w - plain).abs().max()),
                  float((y_prequant - plain).abs().max()))
        require(torch.equal(y_float_w, plain) and torch.equal(y_prequant, plain),
                f"int8_matmul {M}x{K}x{N} differs from its plain version "
                f"(max abs {err})")
        # the GEMM may start before its row pre-pass ends (programmatic
        # dependent launch): with the allocator's scratch NaN-filled, a read
        # of qx or sx ahead of the wait shows
        for _ in range(10):
            junk = [torch.full((n,), float("nan"), device="cuda")
                    for n in (M * K // 4, M, M * N, 4096)]
            del junk
            require(torch.equal(k8.int8_matmul(x, wq, w_scale=sw), plain),
                    f"int8_matmul {M}x{K}x{N} read stale scratch")
        max_err = max(max_err, err)
        cost = registry.get_kernel("int8_matmul").cost([x, wq, sw], [plain])
        bound_s, bound_by = cost.bound()
        sx = torch.clamp_min(x.abs().amax(1, keepdim=True) * k8.INV_127, 1e-30)
        qx = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
        # torch._int_mm (cuBLASLt) takes M > 16 and K, N multiples of 8
        int_mm_ok = M > 16 and K % 8 == 0 and N % 8 == 0
        row = {
            "phase": "kernel", "name": "int8_matmul", "M": M, "K": K, "N": N,
            "bitwise_equal_plain": True, "max_abs_err": err,
            "ms": time_ms(torch, lambda: k8.int8_matmul(x, wq, w_scale=sw)),
            "plain_ms": time_ms(torch, lambda: k8.int8_matmul_plain(x, wq, sw)),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "int_mm_ms": (time_ms(torch, lambda: torch._int_mm(qx, wq.t()))
                          if int_mm_ok else None),
            "f32_matmul_ms": time_ms(torch, lambda: torch.matmul(x, w.t())),
            "bytes": cost.bytes, "ops": cost.flops,
        }
        emit(row)
        rows.append(row)
    return rows, max_err


def phase_slice(torch, mt, k8):
    """Full-width ResNet-50 served through Predictor on the card."""
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.models import resnet50

    mt.set_matmul_precision("highest")
    net = resnet50(num_classes=1000)
    data_shape = (BATCH, 3, 224, 224)
    args, aux = random_params(net, SEED, data=data_shape)
    rng = np.random.default_rng(SEED + 1)
    images = [rng.standard_normal(data_shape, np.float32)
              for _ in range(REQUESTS)]

    gpu = mt.gpu(0)
    p8 = mt.Predictor(net, args, aux, ctx=gpu, quantize="int8")
    p32 = mt.Predictor(net, args, aux, ctx=gpu)
    p8.forward(data=images[0]).get_output(0)   # warm-up: cuDNN, allocator
    p32.forward(data=images[0]).get_output(0)
    torch.cuda.synchronize()

    def serve(pred):
        outs, lat = [], []
        for img in images:
            t0 = time.perf_counter()
            outs.append(pred.forward(data=img).get_output(0))
            lat.append((time.perf_counter() - t0) * 1e3)
        return outs, lat

    # the main path: every kernel count is read around the int8 serving run
    k8.int8_matmul.launches = 0
    out8, lat8 = serve(p8)
    launches = {"int8_matmul": k8.int8_matmul.launches}
    out32, lat32 = serve(p32)

    for o in out8 + out32:
        require(o.shape == (BATCH, 1000) and np.isfinite(o).all(),
                "outputs are finite (32, 1000)")
    require(launches["int8_matmul"] == REQUESTS,
            f"int8_matmul launched {launches['int8_matmul']} times in "
            f"{REQUESTS} int8 requests (ResNet-50 has one FullyConnected)")
    o8, o32 = np.concatenate(out8), np.concatenate(out32)
    # Per-row int8 quantization of the pooled post-ReLU features, whose
    # largest entries set each row's scale, costs 1-2% of the logits with
    # these weights (CPU rehearsal: 1.4e-2), hence 3e-2.
    logit_err = rel_fro(centered_logits(o8), centered_logits(o32))
    require(logit_err < 3e-2, f"int8 vs f32 logits rel. error {logit_err}")
    agree = float((o8.argmax(1) == o32.argmax(1)).mean())
    require(agree >= 0.9, f"int8 vs f32 argmax agreement {agree}")

    # The card against the CPU (plain int8 version, oneDNN convolutions) on
    # two images. Both sum in f32 in different orders through 53 layers, and
    # in int8 a feature on a rounding boundary may move its code by one step,
    # as the CPU tests allow (1e-3). Readings on the H100 were 1.5e-7 to
    # 3.6e-7 for both (PERF.md), so 1e-3 leaves room for these and no more.
    for quant, out, bound in ((None, out32[0], 1e-3), ("int8", out8[0], 1e-3)):
        ref = mt.Predictor(net, args, aux, ctx=mt.cpu(), quantize=quant)
        ref_out = ref.forward(data=images[0][:2]).get_output(0)
        err = rel_fro(centered_logits(out[:2]), centered_logits(ref_out))
        require(err < bound, f"card vs CPU ({quant}) logits rel. error {err}")
        emit({"phase": "card_vs_cpu", "quantize": quant, "rel_err": err,
              "bound": bound})

    # where an int8 request's time goes, on the host clock: the input's copy
    # to the card, the forward, the output's copy back
    split = {"set_input_ms": [], "forward_ms": [], "get_output_ms": []}
    for img in images:
        t0 = time.perf_counter()
        p8.set_input("data", img)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p8.forward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        p8.get_output(0)
        t3 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[key].append(dt * 1e3)
    emit({"phase": "int8_request_split",
          **{k: statistics.median(v) for k, v in split.items()}})

    row = {"phase": "slice", "model": "resnet50", "batch": BATCH,
           "image": [3, 224, 224], "classes": 1000, "requests": REQUESTS,
           "int8_logit_rel_err": logit_err, "int8_argmax_agree": agree,
           "launches": launches}
    for tag, lat in (("int8", lat8), ("f32", lat32)):
        med = statistics.median(lat)
        row[f"{tag}_request_ms"] = lat
        row[f"{tag}_request_ms_median"] = med
        row[f"{tag}_images_per_s"] = BATCH * 1e3 / med
    emit(row)
    return launches


def resnet50_leaf_shapes():
    from mxnet_tpu_torch.models import resnet50

    net = resnet50(num_classes=1000)
    arg_shapes, _, _ = net.infer_shape(data=(BATCH, 3, 224, 224))
    return {n: s for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def adam_configs(topt):
    """The two step kinds the kernel serves: Adam with rescale, clip and L2
    decay through the gradient, and AdamW with a decay filter."""
    return {
        "adam": lambda fused: topt.Adam(
            learning_rate=LEARNING_RATE, rescale_grad=1.0 / BATCH,
            clip_gradient=1.0, wd=1e-4, fused=fused),
        "adamw": lambda fused: topt.AdamW(
            learning_rate=LEARNING_RATE, rescale_grad=1.0 / BATCH,
            weight_decay=0.05, decay_filter=lambda n: n.endswith("_weight"),
            fused=fused),
    }


def phase_fused_adam(torch, topt, kfa, registry):
    """fused_adam against its plain version and the per-leaf path, bitwise,
    over 3 steps; then its times at ResNet-50's parameter set."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    max_err, rows = 0.0, {}
    for set_name, shapes in (("resnet50", resnet50_leaf_shapes()),
                             ("odd", ODD_SHAPES)):
        names = list(shapes)
        w0 = {k: randn(shapes[k]) for k in names}
        # gradients of a batch sum: large enough that rescale and clip act
        grads = [{k: randn(shapes[k], 2.0 * BATCH) for k in names}
                 for _ in range(3)]
        for cfg_name, make in adam_configs(topt).items():
            opt_k, opt_p, opt_l = make(True), make(True), make(False)
            pk = {k: v.clone() for k, v in w0.items()}
            pp = {k: v.clone() for k, v in w0.items()}
            pl = {k: v.clone() for k, v in w0.items()}
            sk, sp, sl = (o.init_state_tree(pk) for o in (opt_k, opt_p, opt_l))
            for step in range(3):
                g = grads[step]
                with torch.no_grad():
                    pk, sk = opt_k.apply(pk, g, sk, LEARNING_RATE)
                    t_new, scalars, hyper = opt_p._fused_args(names, sp)
                    kfa.fused_adam_plain(
                        [pp[k] for k in names], [g[k] for k in names],
                        [sp[k][0] for k in names], [sp[k][1] for k in names],
                        *scalars, lr=LEARNING_RATE, **hyper)
                    sp = {k: (sp[k][0], sp[k][1], t_new[k]) for k in names}
                    pl, sl = opt_l.apply(pl, g, sl, LEARNING_RATE)
                torch.cuda.synchronize()
                for k in names:
                    for kern, plain, leaf in ((pk[k], pp[k], pl[k]),
                                              (sk[k][0], sp[k][0], sl[k][0]),
                                              (sk[k][1], sp[k][1], sl[k][1])):
                        err = float((kern - plain).abs().max()) \
                            if kern.numel() else 0.0
                        max_err = max(max_err, err)
                        require(torch.equal(kern, plain),
                                f"fused_adam {set_name}/{cfg_name} step {step} "
                                f"leaf {k}: kernel differs from its plain "
                                f"version (max abs {err})")
                        require(torch.equal(kern, leaf),
                                f"fused_adam {set_name}/{cfg_name} step {step} "
                                f"leaf {k}: kernel differs from the per-leaf "
                                "Optimizer.apply")
            emit({"phase": "fused_adam_parity", "set": set_name,
                  "config": cfg_name, "leaves": len(names), "steps": 3,
                  "bitwise_equal_plain": True,
                  "bitwise_equal_per_leaf": True})
        if set_name != "resnet50":
            continue
        # times at ResNet-50's set, Adam step, the main path's shapes
        opt = adam_configs(topt)["adam"](True)
        ws = [w0[k].clone() for k in names]
        gs = [grads[0][k] for k in names]
        states = opt.init_state_tree(dict(zip(names, ws)))
        ms = [states[k][0] for k in names]
        vs = [states[k][1] for k in names]
        _, scalars, hyper = opt._fused_args(names, states)
        table = kfa.LeafTable()

        def kernel():
            kfa.fused_adam(ws, gs, ms, vs, *scalars, lr=LEARNING_RATE,
                           table=table, **hyper)

        def plain():
            kfa.fused_adam_plain(ws, gs, ms, vs, *scalars, lr=LEARNING_RATE,
                                 **hyper)

        lib_params = [w.clone().requires_grad_(True) for w in ws]
        for p_, g_ in zip(lib_params, gs):
            p_.grad = g_.clone()
        lib_opt = torch.optim.Adam(lib_params, lr=LEARNING_RATE,
                                   weight_decay=1e-4, fused=True)
        cost = registry.get_kernel("fused_adam").cost([ws, gs, ms, vs],
                                                      [ws, ms, vs])
        bound_s, bound_by = cost.bound()
        with torch.no_grad():
            # the wrapper's host work (checks of 644 tensors, the per-step
            # table) can outlast the default spin on a slow host
            rows = {"ms": time_ms(torch, kernel, spin=10_000_000),
                    "plain_ms": time_ms(torch, plain, reps=5),
                    "library_ms": time_ms(torch, lib_opt.step,
                                          spin=10_000_000),
                    "bound_ms": bound_s * 1e3, "bound_by": bound_by}
        emit({"phase": "kernel", "name": "fused_adam", "set": set_name,
              "leaves": len(names), "elements": sum(w.numel() for w in ws),
              "work_items": table.n_items, "bytes": cost.bytes,
              "ops": cost.flops, **rows,
              "library": "torch.optim.Adam(fused=True).step()"})
    return rows, max_err


def step_loss_metric(mt):
    """A metric holding SoftmaxOutput.loss_value of each step's training
    outputs, per image; reading it syncs the host with the step."""
    from mxnet_tpu_torch.ops import OPS

    head = OPS.create("SoftmaxOutput")

    class StepLoss(mt.metric.EvalMetric):
        def __init__(self):
            super().__init__("softmax_loss")
            self.steps = []

        def update(self, labels, preds):
            value = float(head.loss_value(preds[0], labels[0])) / BATCH
            self.steps.append(value)
            self.sum_metric += value
            self.num_inst += 1

    return StepLoss()


def fit_one_batch(torch, mt, net, args, aux, batch_x, batch_y,
                  steps=None, **model_kw):
    """``steps`` steps of ``FeedForward(ctx=gpu(0), optimizer="adam",
    fused=True)`` on one fixed batch (the run overfits it), then one step
    split into its phases on the card's clock (median of 5). Returns the
    model and a row: fused_adam's launches in the fit, each step's loss,
    step ms, images per second, the split and the fit's peak memory (the
    peak above what was allocated when it started)."""
    steps = steps or TRAIN_STEPS
    shape = batch_x.shape
    X = np.ascontiguousarray(np.broadcast_to(
        batch_x, (steps,) + shape).reshape((-1,) + shape[1:]))
    Y = np.tile(batch_y, steps)
    metric, stamps = step_loss_metric(mt), []
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="adam",
                           fused=True, learning_rate=LEARNING_RATE,
                           arg_params=args, aux_params=aux, **model_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    # the main path: every kernel's count is read around the fit
    reset_launches()
    model.fit(mt.io.NDArrayIter(X, Y, batch_size=len(batch_x)),
              eval_metric=metric,
              batch_end_callback=lambda p: stamps.append(time.perf_counter()))
    launches = read_launches()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    losses = metric.steps
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    median_ms = statistics.median(step_ms)

    state = model._train_state
    arrays = {"data": torch.from_numpy(batch_x).cuda(),
              "softmax_label": torch.from_numpy(batch_y).cuda()}
    split = {"forward_ms": [], "backward_ms": [], "update_ms": []}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        state.prepare(LEARNING_RATE)
        ev[0].record()
        state.forward(arrays)
        ev[1].record()
        state.backward()
        ev[2].record()
        state.update()
        ev[3].record()
        torch.cuda.synchronize()
        for key, (a, b) in zip(split, zip(ev, ev[1:])):
            split[key].append(a.elapsed_time(b))
    row = {"launches": launches, "loss_first": losses[0],
           "loss_last": losses[-1], "losses": list(losses),
           "step_ms": step_ms, "step_ms_median": median_ms,
           "images_per_s": len(batch_x) * 1e3 / median_ms,
           "split": {k: statistics.median(v) for k, v in split.items()},
           "peak_memory_gb": peak_gb}
    return model, row


def require_trained(row, steps, what, halves=False):
    """fused_adam once a step, a finite loss at every step that fell on
    the overfit batch: the last below the first, or with ``halves`` (a net
    with Dropout, whose loss jumps from step to step) the mean of the
    second half below the mean of the first."""
    require(row["launches"]["fused_adam"] == steps,
            f"{what}: fused_adam launched {row['launches']['fused_adam']} "
            f"times in {steps} steps (one whole-tree launch per step)")
    losses = row["losses"]
    require(len(losses) == steps and np.isfinite(losses).all(),
            f"{what}: finite loss at every step: {losses}")
    half = len(losses) // 2
    fell = np.mean(losses[-half:]) < np.mean(losses[:half]) if halves \
        else losses[-1] < losses[0]
    require(fell, f"{what}: the loss of the overfit batch fell: {losses}")


def resnet50_case():
    """The training phases' ResNet-50, seeded weights and one batch."""
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.models import resnet50

    net = resnet50(num_classes=1000)
    shape = (BATCH,) + IMAGE
    args, aux = random_params(net, SEED, data=shape)
    rng = np.random.default_rng(SEED + 2)
    batch_x = rng.standard_normal(shape, np.float32)
    batch_y = rng.integers(0, 1000, BATCH).astype(np.float32)
    return net, args, aux, batch_x, batch_y


def phase_train(torch, mt):
    """Full-width ResNet-50 trained through FeedForward.fit on the card."""
    mt.set_matmul_precision("highest")
    net, args, aux, batch_x, batch_y = resnet50_case()
    shape = batch_x.shape
    model, fit_row = fit_one_batch(torch, mt, net, args, aux, batch_x,
                                   batch_y)
    launches = {"fused_adam": fit_row["launches"]["fused_adam"]}
    table = model._optimizer_obj._leaf_table
    table_builds = {"builds": table.builds,
                    "grad_uploads": table.grad_uploads}
    require_trained(fit_row, TRAIN_STEPS, "train")
    for k, v in model.arg_params.items():
        v = v.numpy()
        require(np.isfinite(v).all(), f"parameter {k} is finite")
        require(not np.array_equal(v, args[k]), f"parameter {k} changed")
    for k, v in model.aux_params.items():
        require(np.isfinite(v.numpy()).all(), f"auxiliary state {k} is finite")

    # the card against the CPU: one forward+backward at batch 4, the same
    # params and images; per-leaf relative Frobenius error of the gradients.
    # Both f32 runs are also held against the CPU in f64: at batch 4 the last
    # stage's BatchNorms normalise 196 values a channel, and f32 gradients of
    # this random ResNet-50 carry 0.2-1% error on either device (readings in
    # PERF.md), so the card must be as close to f64 as the CPU is.
    small = (4,) + shape[1:]

    def bound_grads(ctx, dtype):
        names = net.list_arguments()
        values = {k: v.astype(dtype) for k, v in args.items()}
        values.update(data=batch_x[:4].astype(dtype),
                      softmax_label=batch_y[:4])
        ex = net.bind(ctx, values,
                      args_grad={k: np.zeros(v.shape, dtype)
                                 for k, v in args.items()},
                      grad_req={k: "write" if k in args else "null"
                                for k in names},
                      aux_states={k: v.astype(dtype) for k, v in aux.items()})
        ex.forward(is_train=True)
        ex.backward()
        return {k: ex.grad_dict[k].cpu().double().numpy() for k in args}

    def leaf_errors(got, want):
        return {k: float(np.linalg.norm(got[k] - want[k])
                         / max(np.linalg.norm(want[k]), 1e-30)) for k in args}

    card = bound_grads(mt.gpu(0), np.float32)
    host = bound_grads(mt.cpu(), np.float32)
    exact = bound_grads(mt.cpu(), np.float64)
    errs = {"card_vs_cpu": leaf_errors(card, host),
            "card_vs_f64": leaf_errors(card, exact),
            "cpu_vs_f64": leaf_errors(host, exact)}
    summary = {name: {"median": statistics.median(e.values()),
                      "worst": sorted(e.items(), key=lambda kv: -kv[1])[:3]}
               for name, e in errs.items()}
    emit({"phase": "card_vs_cpu_grads", "batch": 4, "leaves": len(args),
          **summary, "bounds": {"card_vs_cpu_worst": 3e-2,
                                "card_vs_cpu_median": 1e-2,
                                "card_over_cpu_vs_f64": [2.0, 3.0]}})
    worst = summary["card_vs_cpu"]["worst"][0]
    require(worst[1] < 3e-2 and summary["card_vs_cpu"]["median"] < 1e-2,
            f"card vs CPU gradient rel. error {worst[1]} at {worst[0]}, "
            f"median {summary['card_vs_cpu']['median']}")
    for stat, factor in (("median", 2.0), ("worst", 3.0)):
        def pick(name):
            v = summary[name][stat]
            return v if stat == "median" else v[0][1]
        require(pick("card_vs_f64") <= factor * pick("cpu_vs_f64"),
                f"card gradients {pick('card_vs_f64')} from f64 ({stat}) "
                f"against the CPU's {pick('cpu_vs_f64')}")
    row = {"phase": "train", "model": "resnet50", "batch": BATCH,
           "image": [3, 224, 224], "classes": 1000, "steps": TRAIN_STEPS,
           "optimizer": "adam", "fused": True, "learning_rate": LEARNING_RATE,
           "precision": "highest", "leaf_table": table_builds,
           **{k: v for k, v in fit_row.items() if k != "losses"}}
    emit(row)
    return launches, row


def flash_row_bound(torch, dtype):
    """Kernel against plain version, row by row: each (batch, head, row)'s
    error over head_dim (rows of o and dq are queries, of dk and dv keys)
    within ``tol`` of that row's norm, plus ``ROW_FLOOR`` of the slab's RMS
    row norm, so that late causal rows and keys, whose values are a few
    hundredths, are held about as tightly as the large ones. Sums run in
    another order (mma fragments against blocked matmuls; no atomics, so the
    kernel repeats itself bitwise), and in bf16 an output, p or ds may round
    to the other neighbour: one bf16 step of each element is at most 2^-7
    of its row (readings up to 3.6e-3). In f32, 1e-5 (readings up to
    7.7e-7)."""
    return 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5


# A row whose value cancels to rounding noise (dq of the first query, which
# sees one key: dp - delta is zero up to f32 rounding) has no relative error
# to hold; its noise read 0.7-1.8e-6 of the slab's RMS row norm, and
# 2^-16 = 1.5e-5 of it leaves room for that and for nothing a real row holds.
ROW_FLOOR = 2.0 ** -16
# lse is f32 on both sides: |error| <= 1e-5 * max(1, |lse|)
LSE_BOUND = 1e-5


def row_errors(torch, got, want, tol):
    """``(error / allowed, error / norm)`` per (batch, head, row), the second
    over the rows whose norm is at least 2^-7 of the slab's RMS (rows not
    lost to cancellation)."""
    g, w = got.float(), want.float()
    err, norm = (g - w).norm(dim=-1), w.norm(dim=-1)
    rms = norm.pow(2).mean(-1, keepdim=True).sqrt()
    share = err / (tol * norm + ROW_FLOOR * rms).clamp_min(
        torch.finfo(torch.float32).tiny)
    real = norm >= 2.0 ** -7 * rms
    rel = torch.where(real, err / norm.clamp_min(
        torch.finfo(torch.float32).tiny), torch.zeros_like(err))
    return share, rel


def flash_operands(torch, shape, dtype, gen, seq_k=None):
    """q, k, v as the transformer hands them (views of one packed
    (b, s, 3, h, d) qkv), and do; with ``seq_k``, k and v of their own."""
    b, h, s, d = shape
    if seq_k is None:
        qkv = torch.randn((b, s, 3, h, d), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    else:
        q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, h, seq_k, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
    do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def phase_flash(torch, tfa, registry):
    """The three flash kernels against their plain versions, and their
    times at the LM's shape."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    rows = {}
    for shape, dtype_name, causal, seq_k in FLASH_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, do = flash_operands(torch, shape, dtype, gen, seq_k)
        o, lse = tfa.flash_fwd(q, k, v, causal)
        delta = tfa.attention_delta(o, do)
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        again = (*tfa.flash_fwd(q, k, v, causal),
                 tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
                 *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
        po, plse = tfa.flash_fwd_plain(q, k, v, causal)
        pdq, pdk, pdv = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in
                    zip((o, lse, dq, dk, dv), again)),
                f"flash kernels {shape} repeat themselves bitwise")
        bound = flash_row_bound(torch, dtype)
        lse_err = float(((lse - plse).abs() / plse.abs().clamp_min(1)).max())
        case = {"lse": {"max_rel_err": lse_err,
                        "max_abs_err": float((lse - plse).abs().max())}}
        shares = {}
        for kernel, name, got, want in (
                ("flash_fwd", "o", o, po), ("flash_bwd_dq", "dq", dq, pdq),
                ("flash_bwd_dkv", "dk", dk, pdk),
                ("flash_bwd_dkv", "dv", dv, pdv)):
            share, rel = row_errors(torch, got, want, bound)
            shares[name] = (kernel, float(share.max()))
            err = float((got.float() - want.float()).abs().max())
            errs[kernel] = max(errs[kernel], err)
            late = rel[..., 3 * rel.shape[-1] // 4:]
            case[name] = {"max_abs_err": err,
                          "share_of_bound_max": shares[name][1],
                          "row_rel_err_max": float(rel.max()),
                          "row_rel_err_median": float(rel.median()),
                          # the last quarter of rows: late queries or keys
                          "row_rel_err_max_late": float(late.max())}
        errs["flash_fwd"] = max(errs["flash_fwd"], case["lse"]["max_abs_err"])
        emit({"phase": "flash_parity", "shape": list(shape),
              "seq_k": k.shape[2], "dtype": dtype_name, "causal": causal,
              "errors": case,
              "row_rel_bound": bound, "row_floor_of_rms": ROW_FLOOR,
              "lse_rel_bound": LSE_BOUND, "bitwise_repeat": True})
        require(lse_err <= LSE_BOUND,
                f"flash_fwd {shape} {dtype_name} causal={causal}: lse differs "
                f"from the plain version by {lse_err} relative")
        for name, (kernel, worst) in shares.items():
            require(worst <= 1.0,
                    f"{kernel} {shape} {dtype_name} causal={causal}: a row of "
                    f"{name} differs from the plain version by {worst} of "
                    f"its bound ({bound} of its norm + {ROW_FLOOR} of the "
                    "RMS row)")
        if shape != FLASH_CASES[0][0]:
            continue
        # times at the LM's shape; the library call gets contiguous copies
        qc, kc, vc = (t.detach().contiguous().requires_grad_(True)
                      for t in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qc, kc, vc, is_causal=causal)
        costs = {
            "flash_fwd": registry.get_kernel("flash_fwd").cost(
                [q, k, v], [o, lse], causal=causal),
            "flash_bwd_dq": registry.get_kernel("flash_bwd_dq").cost(
                [q, k, v, do, lse, delta], [dq], causal=causal),
            "flash_bwd_dkv": registry.get_kernel("flash_bwd_dkv").cost(
                [q, k, v, do, lse, delta], [dk, dv], causal=causal),
        }
        plain_bwd_ms = time_ms(torch, lambda: tfa.flash_bwd_plain(
            q, k, v, do, lse, delta, causal), reps=5)
        lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            lib_o, (qc, kc, vc), do, retain_graph=True))
        timed = {
            "flash_fwd": (
                time_ms(torch, lambda: tfa.flash_fwd(q, k, v, causal)),
                time_ms(torch, lambda: tfa.flash_fwd_plain(q, k, v, causal),
                        reps=5),
                time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=causal))),
            "flash_bwd_dq": (
                time_ms(torch, lambda: tfa.flash_bwd_dq(
                    q, k, v, do, lse, delta, causal)),
                plain_bwd_ms, lib_bwd_ms),
            "flash_bwd_dkv": (
                time_ms(torch, lambda: tfa.flash_bwd_dkv(
                    q, k, v, do, lse, delta, causal)),
                plain_bwd_ms, lib_bwd_ms),
        }
        for name, (ms, plain_ms, lib_ms) in timed.items():
            bound_s, bound_by = costs[name].bound()
            rows[name] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_s * 1e3,
                          "bound_by": bound_by}
            emit({"phase": "kernel", "name": name, "shape": list(shape),
                  "dtype": dtype_name, "causal": causal,
                  "ops": costs[name].flops, "bytes": costs[name].bytes,
                  **rows[name], "share_of_bound": bound_s * 1e3 / ms,
                  # the compiled kernel this call launches, per block
                  "attributes": tfa.kernel_attributes(name, dtype,
                                                      shape[3]),
                  "attributes_head_dim_128": tfa.kernel_attributes(
                      name, dtype, 128),
                  "library": ("F.scaled_dot_product_attention"
                              if name == "flash_fwd" else
                              "its backward (dq, dk and dv together)"),
                  "plain": ("flash_fwd_plain" if name == "flash_fwd" else
                            "flash_bwd_plain (dq, dk and dv together)")})
    return rows, errs


def lm_tokens(rng, batch, seq, vocab):
    return (rng.integers(0, vocab, (batch, seq)),
            rng.integers(0, vocab, (batch, seq)))


def lm_card_vs_cpu(torch, mt, TransformerLM, transformer_lm_config, params):
    """Logits and gradients of the f32 LM at the cut size, on the card
    (flash kernels) and on the CPU (dense attention), from the same
    parameters: relative Frobenius errors."""
    cfg = transformer_lm_config(dtype=torch.float32)
    model = TransformerLM(cfg)
    tokens, targets = lm_tokens(np.random.default_rng(SEED + 5), *LM_CUT,
                                cfg["vocab_size"])
    out = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        dev = ctx.torch_device
        leaves = {k: v.detach().to(dev).requires_grad_(True)
                  for k, v in params.items()}
        logits = model.forward(leaves, torch.from_numpy(tokens))
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg["vocab_size"]),
            torch.from_numpy(targets).to(dev).reshape(-1))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out[ctx.device_type] = (
            logits.detach().cpu().double().numpy(),
            {k: g.cpu().double().numpy() for k, g in zip(leaves, grads)})
    card, host = out["gpu"], out["cpu"]
    logit_err = rel_fro(card[0], host[0])
    grad_errs = {k: float(np.linalg.norm(card[1][k] - host[1][k])
                          / max(np.linalg.norm(host[1][k]), 1e-30))
                 for k in params}
    return logit_err, grad_errs


def phase_lm_serve(torch, mt, tfa):
    """The full-width LM's forward on the card: logits of 8 x 2048 tokens."""
    from mxnet_tpu_torch.models import TransformerLM, transformer_lm_config

    # the f32 card-vs-CPU check below; the bf16 GEMMs' rounding is the model's
    mt.set_matmul_precision("highest")
    cfg = transformer_lm_config()
    model = TransformerLM(cfg)
    params = model.init_params(SEED, ctx=mt.gpu(0))
    rng = np.random.default_rng(SEED + 3)
    requests = [torch.from_numpy(lm_tokens(rng, LM_BATCH, LM_SEQ,
                                           cfg["vocab_size"])[0]).cuda()
                for _ in range(LM_REQUESTS)]
    with torch.no_grad():
        model.forward(params, requests[0])   # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        # the main path: the kernel's count is read around the requests
        tfa.flash_fwd.launches = 0
        lat, finite = [], True
        for tokens in requests:
            t0 = time.perf_counter()
            logits = model.forward(params, tokens)
            finite = finite and bool(torch.isfinite(logits).all())
            lat.append((time.perf_counter() - t0) * 1e3)
        launches = {"flash_fwd": tfa.flash_fwd.launches}
    require(tuple(logits.shape) == (LM_BATCH, LM_SEQ, cfg["vocab_size"])
            and logits.dtype == torch.float32 and finite,
            f"logits are finite f32 {(LM_BATCH, LM_SEQ, cfg['vocab_size'])}")
    require(launches["flash_fwd"] == cfg["n_layers"] * LM_REQUESTS,
            f"flash_fwd launched {launches['flash_fwd']} times in "
            f"{LM_REQUESTS} forwards of {cfg['n_layers']} layers")
    del logits
    # The card (flash kernels, f32 on the CUDA cores, cuBLAS f32 without
    # TF32) against the CPU (dense attention) in f32 at 1 x 256 tokens:
    # sums in other orders through 4 layers and a 32000-way projection.
    # 1e-5 leaves room above f32's rounding (the CPU tests read 1e-7 at
    # their width) and none for a wrong mask, scale or tile.
    logit_err, grad_errs = lm_card_vs_cpu(torch, mt, TransformerLM,
                                          transformer_lm_config, params)
    require(logit_err < 1e-5, f"LM card vs CPU logits rel. error {logit_err}")
    med = statistics.median(lat)
    emit({"phase": "lm_serve", "batch": LM_BATCH, "seq": LM_SEQ,
          "config": {k: str(v) for k, v in cfg.items()},
          "params": sum(v.numel() for v in params.values()),
          "requests": LM_REQUESTS, "launches": launches,
          "card_vs_cpu_logits_rel_err": logit_err, "bound": 1e-5,
          "request_ms": lat, "request_ms_median": med,
          "tokens_per_s": LM_BATCH * LM_SEQ * 1e3 / med})
    return launches, params, grad_errs


def phase_lm_train(torch, mt, topt, tfa, kfa, params0, grad_errs):
    """The full-width LM trained 8 steps through make_train_step with the
    fused Adam step, on one fixed batch."""
    from mxnet_tpu_torch.models import TransformerLM, transformer_lm_config

    cfg = transformer_lm_config()
    model = TransformerLM(cfg)
    opt = topt.create("adam", learning_rate=LEARNING_RATE, fused=True)
    params = {k: v.clone() for k, v in params0.items()}
    state = opt.init_state_tree(params)
    step = model.make_train_step(None, optimizer=opt)
    tokens, targets = (torch.from_numpy(t).cuda() for t in lm_tokens(
        np.random.default_rng(SEED + 4), LM_BATCH, LM_SEQ,
        cfg["vocab_size"]))
    kernels = {n: getattr(tfa, n) for n in FLASH_NAMES}
    kernels["fused_adam"] = kfa.fused_adam
    torch.cuda.synchronize()
    # the main path: every count is read around the 8 steps
    for fn in kernels.values():
        fn.launches = 0
    losses, stamps = [], [time.perf_counter()]
    for _ in range(LM_STEPS):
        params, state, loss = step(params, state, tokens, targets)
        losses.append(float(loss))   # syncs the host with the step
        stamps.append(time.perf_counter())
    launches = {n: fn.launches for n, fn in kernels.items()}
    # the step is captured (slice 16): its program keeps its gradients in
    # buffers of its own and its own fused_adam table, built and uploaded
    # once at the warm-up step, never inside the capture
    require(len(step.programs) == 1, "lm_train: one captured program")
    prog_table = next(iter(step.programs.values()))["table"]
    table = {"builds": prog_table.builds,
             "grad_uploads": prog_table.grad_uploads}
    require(table["builds"] == 1 and table["grad_uploads"] <= LM_STEPS,
            f"lm_train: fused_adam's leaf table built once: {table}")
    per_step = {"flash_fwd": cfg["n_layers"], "flash_bwd_dq": cfg["n_layers"],
                "flash_bwd_dkv": cfg["n_layers"], "fused_adam": 1}
    for n, k in per_step.items():
        require(launches[n] == k * LM_STEPS,
                f"{n} launched {launches[n]} times in {LM_STEPS} steps "
                f"(expected {k} a step)")
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f"the loss of the fixed batch fell: {losses}")
    for k, v in params.items():
        require(bool(torch.isfinite(v).all()), f"parameter {k} is finite")
        require(not torch.equal(v, params0[k]), f"parameter {k} changed")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    median_ms = statistics.median(step_ms)

    # one step split into its phases, on the card's clock
    split = {"forward_ms": [], "backward_ms": [], "update_ms": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = model.loss(leaves, tokens, targets)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        ev[2].record()
        with torch.no_grad():
            grads = {k: g.contiguous() for k, g in zip(leaves, grads)}
            params, state = opt.apply(params, grads, state, opt.lr)
        ev[3].record()
        torch.cuda.synchronize()
        for key, (a, b) in zip(split, zip(ev, ev[1:])):
            split[key].append(a.elapsed_time(b))
    split = {k: statistics.median(v) for k, v in split.items()}

    # The card's f32 gradients at 1 x 256 tokens against the CPU's (taken in
    # lm_card_vs_cpu, from the same initial parameters): the same sums in
    # other orders, per leaf relative Frobenius error. The embedding rows of
    # tokens seen once carry one token's gradient and are the noisiest.
    worst = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:3]
    median_err = statistics.median(grad_errs.values())
    emit({"phase": "lm_card_vs_cpu_grads", "cut": list(LM_CUT),
          "leaves": len(grad_errs), "median": median_err, "worst": worst,
          "bounds": {"worst": 1e-4, "median": 1e-5}})
    require(worst[0][1] < 1e-4 and median_err < 1e-5,
            f"LM card vs CPU gradient rel. error {worst[0]}, median "
            f"{median_err}")
    emit({"phase": "lm_train", "batch": LM_BATCH, "seq": LM_SEQ,
          "steps": LM_STEPS, "optimizer": "adam", "fused": True,
          "learning_rate": LEARNING_RATE, "launches": launches,
          "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
          "step_ms": step_ms, "step_ms_median": median_ms,
          "tokens_per_s": LM_BATCH * LM_SEQ * 1e3 / median_ms,
          "split": split, "leaf_table": table})
    return launches


def phase_lm_head(torch):
    """The LM head's logits GEMM and its two gradients at the LM's full
    shape (8 x 2048 tokens, d_model 512, vocab 32,000), bf16 operands and an
    f32 cotangent at a softmax gradient's scale, on the card: the logits
    and the split-cotangent products' f32 results (before their bf16
    rounding) against the f64 products, each element within 2^-16 of
    sum |a||b| (the bound of the CPU test); autograd's gradients bitwise
    the split products rounded once to bf16; and the forward and backward
    timed beside the f32 CUDA-core route they replace (upcast operands, TF32
    off)."""
    from mxnet_tpu_torch import set_matmul_precision
    from mxnet_tpu_torch.parallel.tensor_parallel import (
        column_parallel, column_parallel_f32, split_cotangent, wide_product)

    bf16 = torch.bfloat16
    n, d, v = LM_BATCH * LM_SEQ, 512, 32000
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    x = torch.randn(n, d, generator=gen, device="cuda").to(bf16)
    w = torch.randn(d, v, generator=gen, device="cuda") / float(np.sqrt(d))
    g = torch.randn(n, v, generator=gen, device="cuda") * 1e-4
    wb = w.to(bf16)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = column_parallel_f32(xs, ws)
    dx, dw = torch.autograd.grad(y, (xs, ws), g)
    errors = {}
    with torch.no_grad():
        hi, lo = split_cotangent(g, bf16)
        split = {"dx": wide_product(hi, wb.t()) + wide_product(lo, wb.t()),
                 "dw": wide_product(x.t(), hi) + wide_product(x.t(), lo)}
        del hi, lo
        for name, got, a, b in (
                ("logits", y.detach(), x, wb),
                ("dx", split["dx"], g, wb.t()),
                ("dw", split["dw"], x.t(), g)):
            exact = a.double() @ b.double()
            scale = a.double().abs() @ b.double().abs()
            errors[name] = float(((got.double() - exact).abs()
                                  / scale).max()) / 2.0 ** -16
            del exact, scale
        rounded = {"dx": bool(torch.equal(dx, split["dx"].to(bf16))),
                   "dw": bool(torch.equal(dw, split["dw"].to(bf16).float()))}
    del y, dx, dw, split

    def new():
        torch.autograd.grad(column_parallel_f32(xs, ws), (xs, ws), g)

    xf = x.float().requires_grad_(True)

    def old():
        torch.autograd.grad(column_parallel(xf, ws.to(bf16).float()),
                            (xf, ws), g)

    set_matmul_precision("highest")
    times = {"f32_route_ms": time_ms(torch, old, reps=5),
             "tensor_core_ms": time_ms(torch, new, reps=5)}
    times["f32_route_again_ms"] = time_ms(torch, old, reps=5)
    times["tensor_core_again_ms"] = time_ms(torch, new, reps=5)
    emit({"phase": "lm_head", "shape": [n, d, v],
          "share_of_2^-16_bound": errors,
          "gradients_are_the_split_products_rounded": rounded,
          "forward_and_backward": times})
    for name, share in errors.items():
        require(share <= 1.0, f"lm_head {name}: {share} of the 2^-16 bound")
    require(all(rounded.values()),
            f"lm_head: autograd's gradients are the split products rounded "
            f"once: {rounded}")
    del x, w, g, wb, xs, ws, xf
    torch.cuda.empty_cache()


def bits_equal(torch, a, b):
    """Bitwise equal, NaN by position (the sign and payload of a NaN are
    the device's)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(na, nb) and torch.equal(a[~na].view(ints),
                                               b[~nb].view(ints))


def comm_rows(torch, gen, shape, chunk, specials=False):
    """Gaussian rows whose chunks differ in scale by up to e^±6; with
    ``specials`` a NaN chunk, an inf chunk, a -inf and an all-zero chunk."""
    x = torch.randn(shape, generator=gen, device="cuda")
    n = x.numel()
    scales = torch.empty(-(-n // chunk), device="cuda").uniform_(
        -6, 6, generator=gen).exp()
    x = (x.reshape(-1) * scales.repeat_interleave(chunk)[:n]).reshape(shape)
    if specials:
        flat = x.view(-1)
        flat[1] = float("nan")
        flat[chunk + 2] = float("inf")
        flat[2 * chunk + 3] = float("-inf")
        flat[3 * chunk:4 * chunk] = 0.0
    return x


def comm_padded(comm, mode, world):
    return comm.padded_flat_size(RESNET50_GRAD, comm.CompressionSpec(mode),
                                 world)


def comm_timed(torch, ck, comm, spec, x):
    """The comm kernels of ``spec``'s mode on the two-rank rows ``x`` (the
    stage-1 quantize, the reduce-scatter's decode and sum, the gather's
    decode), each as ``(kernel, plain, codec, inputs, outputs)`` to time,
    with the payload, its decode round trip, the summed shard and the
    decoded payload. twobit's quantize writes its error, as the exchange
    runs it."""
    from mxnet_tpu_torch.comm.allreduce import _row_sum

    payload, dq = ck.fused_quantize(spec, x, want_dequant=True)
    shard = ck.fused_dequant_sum(spec, payload)
    decoded = ck.fused_dequant(spec, payload)
    if spec.mode == "int8":
        q, scale = payload["q"], payload["scale"]
        timed = {
            "quant_int8": (
                lambda: ck.quant_int8(x, COMM_CHUNK, True),
                lambda: ck.quant_int8_plain(x, COMM_CHUNK, True),
                lambda: comm.decode(spec, comm.encode(spec, x)),
                [x], [q, scale, dq]),
            "dequant_sum_int8": (
                lambda: ck.dequant_sum_int8(q, scale, COMM_CHUNK),
                lambda: ck.dequant_sum_int8_plain(q, scale, COMM_CHUNK),
                lambda: _row_sum(comm.decode(spec, payload)),
                [q, scale], [shard]),
            "dequant_int8": (
                lambda: ck.dequant_int8(q, scale, COMM_CHUNK),
                lambda: ck.dequant_int8_plain(q, scale, COMM_CHUNK),
                lambda: comm.decode(spec, payload),
                [q, scale], [decoded]),
        }
    else:
        q, t = payload["q"], spec.threshold
        err = ck.quant_twobit(x, t, want_err=True)[2]
        timed = {
            "quant_twobit": (
                lambda: ck.quant_twobit(x, t, want_err=True),
                lambda: ck.quant_twobit_plain(x, t, False, True),
                lambda: x - comm.decode(spec, comm.encode(spec, x)),
                [x], [q, err]),
            "dequant_sum_twobit": (
                lambda: ck.dequant_sum_twobit(q, t),
                lambda: ck.dequant_sum_twobit_plain(q, t),
                lambda: _row_sum(comm.decode(spec, payload)),
                [q], [shard]),
            "dequant_twobit": (
                lambda: ck.dequant_twobit(q, t),
                lambda: ck.dequant_twobit_plain(q, t),
                lambda: comm.decode(spec, payload),
                [q], [decoded]),
        }
    return timed, payload, dq, shard, decoded


def kernel_form(ck, name, operand):
    """The form a comm kernel's wrapper picks for ``operand``."""
    if name == "quant_int8":
        return {"kernel_form": ck.quant_int8_form(operand, COMM_CHUNK)}
    if name == "quant_twobit":
        return {"kernel_form": ck.quant_twobit_form(operand),
                "outputs": "q, err"}
    if name == "dequant_int8":
        return {"load_bytes": ck.dequant_int8_load_bytes(operand)}
    if name == "dequant_sum_int8":
        return {"load_bytes": ck.dequant_sum_int8_load_bytes(operand)}
    if name == "dequant_sum_twobit":
        return {"load_bytes": ck.dequant_sum_twobit_load_bytes(operand)}
    return {}


def poison(torch, *specs):
    """Fill, then free, blocks of the caching allocator of the sizes and
    types of the outputs to come, so that their tensors start as 0xff
    bytes: a store a kernel misses then reads code 3 or a NaN."""
    held = [torch.empty(shape, dtype=dtype, device="cuda").view(torch.uint8)
            .fill_(255) for shape, dtype in specs]
    torch.cuda.synchronize()
    del held


def twobit_form_parity(torch, ck, gen):
    """quant_twobit (q, dq and err) and dequant_sum_twobit, in the forms
    their wrappers pick, bitwise their plain versions at TWOBIT_FORM_CASES:
    rows 0, 8 or 1 floats past a 16-byte boundary, and the codes 0, 8, 1
    and 3 bytes past one; every output poisoned first."""
    t = 0.5
    for shape, offset in TWOBIT_FORM_CASES:
        n = shape[0] * shape[1]
        buf = torch.empty(n + 8, device="cuda")
        start = (-buf.data_ptr() // 4) % 4 + offset
        rows = buf[start:start + n].view(shape)
        rows.copy_(comm_rows(torch, gen, shape, COMM_CHUNK,
                             specials=n >= 5 * COMM_CHUNK))
        form = ck.quant_twobit_form(rows)
        require(form == ("vector" if offset % 4 == 0
                         and n >= ck.QUANT_TWOBIT_VECTOR_MIN else "scalar"),
                f"quant_twobit {list(shape)} offset {offset}: form {form}")
        plain = ck.quant_twobit_plain(rows, t, True, True)
        poison(torch, ((n // 4,), torch.uint8), ((n,), torch.float32),
               ((n,), torch.float32))
        got = ck.quant_twobit(rows, t, True, True)
        torch.cuda.synchronize()
        require(all(bits_equal(torch, a, b) for a, b in zip(got, plain)),
                f"quant_twobit ({form}) {list(shape)} offset {offset}: "
                "kernel differs from its plain version")
        q = plain[0]
        loads = []
        for qoff in (0, 8, 1, 3):
            qbuf = torch.empty(q.numel() + 48, dtype=torch.uint8,
                               device="cuda")
            qs = (-qbuf.data_ptr()) % 16 + qoff
            qv = qbuf[qs:qs + q.numel()].view(q.shape)
            qv.copy_(q)
            want = ck.dequant_sum_twobit_plain(qv, t)
            load = ck.dequant_sum_twobit_load_bytes(qv)
            require(load == (4 if q.shape[1] >= ck.DQSUM_TWOBIT_FOUR_MIN
                             else 1),
                    f"dequant_sum_twobit {list(q.shape)}: {load} bytes")
            poison(torch, ((4 * q.shape[1],), torch.float32))
            got = ck.dequant_sum_twobit(qv, t)
            torch.cuda.synchronize()
            require(bits_equal(torch, got, want),
                    f"dequant_sum_twobit ({load} bytes) {list(q.shape)} "
                    f"codes {qoff} bytes off: kernel differs from its plain "
                    "version")
            loads.append(load)
        emit({"phase": "comm_parity",
              "name": "quant_twobit, dequant_sum_twobit",
              "shape": list(shape), "offset_bytes": 4 * offset,
              "quant_twobit_form": form, "outputs": "q, dq, err",
              "dequant_sum_twobit_code_offsets": [0, 8, 1, 3],
              "dequant_sum_twobit_load_bytes": loads,
              "bitwise_equal_plain": True})
        del buf, rows, plain, got, q, qbuf, qv, want


def time_kernel_row(torch, registry, name, kernel, plain, codec, ins, outs,
                    plain_reps=5):
    """A kernel's row: its time, its plain version's, the codec path's
    (the library column) and its bound from the registry's cost."""
    cost = registry.get_kernel(name).cost(ins, outs)
    bound_s, bound_by = cost.bound()
    return {"ms": time_ms(torch, kernel),
            "plain_ms": time_ms(torch, plain, reps=plain_reps),
            "library_ms": time_ms(torch, codec),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by}, cost


def phase_comm_kernels(torch, ck, comm, registry):
    """The six comm kernels against their plain versions on the card,
    bitwise; then their times at ResNet-50's two-rank exchange."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for k in ck.KERNELS:
        k.launches = 0
    cases = [((r, comm_padded(comm, "int8", r) // r), COMM_CHUNK, None, False)
             for r in (2, 4, 8)]
    cases += [((8, 2048), COMM_CHUNK, 512, True), ((64,), 4, None, True)]
    for shape, chunk, block, specials in cases:
        for mode in ("int8", "twobit"):
            spec = comm.CompressionSpec(mode, chunk=chunk)
            x = comm_rows(torch, gen, shape, chunk, specials)
            rows = x if x.dim() == 2 else x[None]
            payload, dq = ck.fused_quantize(spec, x, want_dequant=True,
                                            block_elems=block)
            again = ck.fused_quantize(spec, x, want_dequant=True,
                                      block_elems=block)
            kp = {k: v if v.dim() == 2 else v[None] for k, v in payload.items()}
            if mode == "int8":
                plain = ck.quant_int8_plain(rows, chunk, True)[:3]
                got = (kp["q"], kp["scale"], dq.reshape(rows.shape))
                # the error feedback's x - dq, in both of its roundings
                for rounding in ("fma", "sub"):
                    got += (ck.quant_int8(rows, chunk, err=rounding)[3],)
                    plain += (ck.quant_int8_plain(rows, chunk, False,
                                                  rounding)[3],)
                summed = (ck.dequant_sum_int8(kp["q"], kp["scale"], chunk),
                          ck.dequant_sum_int8_plain(kp["q"], kp["scale"],
                                                    chunk))
                decoded = (ck.dequant_int8(kp["q"], kp["scale"], chunk),
                           ck.dequant_int8_plain(kp["q"], kp["scale"], chunk))
                names = ("quant_int8", "dequant_sum_int8", "dequant_int8")
            else:
                plain = ck.quant_twobit_plain(rows, spec.threshold, True,
                                              True)
                # the stage-1 error the exchange takes from the kernel
                got = (kp["q"], dq.reshape(rows.shape),
                       ck.quant_twobit(rows, spec.threshold,
                                       want_err=True)[2])
                summed = (ck.dequant_sum_twobit(kp["q"], spec.threshold),
                          ck.dequant_sum_twobit_plain(kp["q"], spec.threshold))
                decoded = (ck.dequant_twobit(kp["q"], spec.threshold),
                           ck.dequant_twobit_plain(kp["q"], spec.threshold))
                names = ("quant_twobit", "dequant_sum_twobit",
                         "dequant_twobit")
            repeat = (ck.fused_dequant_sum(spec, kp, block_elems=block),
                      ck.fused_dequant(spec, kp, block_elems=block))
            torch.cuda.synchronize()
            checks = {
                names[0]: all(bits_equal(torch, a, b)
                              for a, b in zip(got, plain)),
                names[1]: bits_equal(torch, *summed),
                names[2]: bits_equal(torch, *decoded)}
            for name, ok in checks.items():
                require(ok, f"{name} {list(shape)} chunk {chunk}: kernel "
                        "differs from its plain version")
            require(all(bits_equal(torch, payload[k], again[0][k])
                        for k in payload)
                    and bits_equal(torch, dq, again[1])
                    and bits_equal(torch, summed[0], repeat[0])
                    and bits_equal(torch, decoded[0].reshape(repeat[1].shape),
                                   repeat[1]),
                    f"comm kernels {mode} {list(shape)} repeat bitwise")
            emit({"phase": "comm_parity", "mode": mode, "shape": list(shape),
                  "chunk": chunk, "block_elems": block,
                  "nan_inf_chunks": specials, "bitwise_equal_plain": True,
                  "bitwise_repeat": True})
    # dequant_sum_int8's char4 and byte loads: rows of 4100 (not a multiple
    # of 16), codes 4 and 1 bytes past a 16-byte boundary
    for offset, load_bytes in ((4, 4), (1, 1)):
        rows, length, chunk = 2, 4100, 20
        buf = torch.empty(rows * length + 48, dtype=torch.int8, device="cuda")
        start = (-buf.data_ptr()) % 16 + offset
        q = buf[start:start + rows * length].view(rows, length)
        q.copy_(torch.randint(-127, 128, (rows, length), generator=gen,
                              device="cuda", dtype=torch.int8))
        scale = torch.rand((rows, length // chunk), generator=gen,
                           device="cuda")
        require(ck.dequant_sum_int8_load_bytes(q) == load_bytes,
                f"dequant_sum_int8 takes its {load_bytes}-byte loads")
        summed = (ck.dequant_sum_int8(q, scale, chunk),
                  ck.dequant_sum_int8_plain(q, scale, chunk))
        torch.cuda.synchronize()
        require(bits_equal(torch, *summed),
                f"dequant_sum_int8 {load_bytes}-byte loads: kernel differs "
                "from its plain version")
        emit({"phase": "comm_parity", "name": "dequant_sum_int8",
              "shape": [rows, length], "chunk": chunk,
              "load_bytes": load_bytes, "bitwise_equal_plain": True})
    # quant_int8's two forms, dequant_int8's three load widths: rows
    # `offset` floats past a 16-byte boundary (a bucket is a view into the
    # flat gradient buffer), codes 0, 4 and 1 bytes past one
    for shape, chunk, offset in INT8_FORM_CASES:
        n = shape[0] * shape[1]
        buf = torch.empty(n + 8, device="cuda")
        start = (-buf.data_ptr() // 4) % 4 + offset
        rows = buf[start:start + n].view(shape)
        rows.copy_(comm_rows(torch, gen, shape, chunk, specials=True))
        form = ck.quant_int8_form(rows, chunk)
        require(form == ("chunked" if offset == 0 and chunk % 128 == 0
                         else "general"),
                f"quant_int8 {list(shape)} chunk {chunk} offset {offset}: "
                f"form {form}")
        for want_dq, rounding in ((True, "sub"), (False, "fma")):
            got = ck.quant_int8(rows, chunk, want_dq, rounding)
            plain = ck.quant_int8_plain(rows, chunk, want_dq, rounding)
            torch.cuda.synchronize()
            require(all(bits_equal(torch, a, b)
                        for a, b in zip(got, plain) if a is not None),
                    f"quant_int8 ({form}) {list(shape)} chunk {chunk} "
                    f"offset {offset} {rounding}: kernel differs from its "
                    "plain version")
        q, scale = got[0], got[1]
        loads = []
        for qoff in (0, 4, 1):
            qbuf = torch.empty(n + 48, dtype=torch.int8, device="cuda")
            qs = (-qbuf.data_ptr()) % 16 + qoff
            qv = qbuf[qs:qs + n].view(shape)
            qv.copy_(q)
            decoded = (ck.dequant_int8(qv, scale, chunk),
                       ck.dequant_int8_plain(qv, scale, chunk))
            torch.cuda.synchronize()
            loads.append(ck.dequant_int8_load_bytes(qv))
            require(bits_equal(torch, *decoded),
                    f"dequant_int8 ({loads[-1]}-byte loads) {list(shape)} "
                    f"chunk {chunk}: kernel differs from its plain version")
        emit({"phase": "comm_parity", "name": "quant_int8, dequant_int8",
              "shape": list(shape), "chunk": chunk, "offset_bytes":
              4 * offset, "quant_int8_form": form,
              "dequant_int8_load_bytes": loads, "nan_inf_chunks": True,
              "bitwise_equal_plain": True})
        del buf, rows, got, plain, q, scale, qbuf, qv, decoded
    twobit_form_parity(torch, ck, gen)
    phase_launches = {k.__name__: k.launches for k in ck.KERNELS}

    # times at the main path's shapes: ResNet-50's padded gradient, two ranks
    rows = {}
    for mode in ("int8", "twobit"):
        spec = comm.CompressionSpec(mode)
        x = comm_rows(torch, gen, (2, comm_padded(comm, mode, 2) // 2),
                      COMM_CHUNK)
        timed, payload, dq, shard, decoded = comm_timed(torch, ck, comm,
                                                        spec, x)
        for name, (kernel, plain, codec, ins, outs) in timed.items():
            rows[name], cost = time_kernel_row(torch, registry, name, kernel,
                                               plain, codec, ins, outs)
            rows[name].update(kernel_form(ck, name, ins[0]))
            emit({"phase": "kernel", "name": name,
                  "shapes": [list(t.shape) for t in ins],
                  "bytes": cost.bytes, "ops": cost.flops, **rows[name],
                  "library": "the codec path's torch composition",
                  "phase_launches": phase_launches[name]})
        if mode == "int8":
            # the stage-2 form: the reduced shard, one row, with its error in
            # the rounding of a many-step JAX grid
            row = shard[None]
            s_q, s_scale, _, s_err = ck.quant_int8(row, COMM_CHUNK, err="sub")
            cost = registry.get_kernel("quant_int8").cost(
                [row], [s_q, s_scale, s_err])
            bound_s, bound_by = cost.bound()
            emit({"phase": "kernel", "name": "quant_int8",
                  "form": "stage 2: one row and its error, err='sub'",
                  "shapes": [list(row.shape)], "bytes": cost.bytes,
                  "ops": cost.flops,
                  "ms": time_ms(torch, lambda: ck.quant_int8(
                      row, COMM_CHUNK, err="sub")),
                  "plain_ms": time_ms(torch, lambda: ck.quant_int8_plain(
                      row, COMM_CHUNK, False, "sub"), reps=5),
                  "bound_ms": bound_s * 1e3, "bound_by": bound_by})
            del row, s_q, s_scale, s_err
        del x, payload, dq, shard, decoded, timed
    return rows, phase_launches


def comm_bucket_rows(torch, ck, comm, registry):
    """Rows 3-7 (the kernels of the overlapped exchange) at one 4 MB
    bucket's two-rank shapes: 1,048,576 f32 elements, two rows of
    524,288; timed as phase comm_kernels times them. Then the twobit
    kernels in each of their forms at TWOBIT_SHAPES, and the 31 stage-1
    quantizes of dp_overlap's buckets as one series."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    # the launch floor: an empty kernel timed as time_ms times a kernel
    floor_ms = time_ms(torch, lambda: torch.cuda._sleep(0))
    emit({"phase": "kernel", "name": "launch floor",
          "form": "torch.cuda._sleep(0), timed as the kernels are",
          "ms": floor_ms})
    rows = {}
    for mode in ("int8", "twobit"):
        spec = comm.CompressionSpec(mode)
        x = comm_rows(torch, gen, (2, BUCKET_ELEMS // 2), COMM_CHUNK)
        timed = comm_timed(torch, ck, comm, spec, x)[0]
        for name, (kernel, plain, codec, ins, outs) in timed.items():
            if name == "dequant_twobit":  # not on the overlap path either
                continue
            rows[name], cost = time_kernel_row(torch, registry, name, kernel,
                                               plain, codec, ins, outs)
            rows[name]["launch_floor_ms"] = floor_ms
            rows[name].update(kernel_form(ck, name, ins[0]))
            emit({"phase": "kernel", "name": name, "form": "4 MB bucket",
                  "shapes": [list(t.shape) for t in ins],
                  "bytes": cost.bytes, "ops": cost.flops, **rows[name],
                  "library": "the codec path's torch composition"})
        del x, timed
    forms = twobit_form_rows(torch, ck, comm, registry, floor_ms)
    for name in ("quant_twobit", "dequant_sum_twobit"):
        rows[name]["forms_by_shape"] = [r for r in forms if r["name"] == name]
    rows["quant_twobit"]["bucket_series"] = twobit_series(torch, ck, comm,
                                                          registry, floor_ms)
    return rows


def twobit_form_rows(torch, ck, comm, registry, floor_ms):
    """quant_twobit, with its error (as the exchange runs it) and with dq,
    and dequant_sum_twobit, in the forms their wrappers pick, at the three
    TWOBIT_SHAPES, each beside its plain version and the codec path."""
    from mxnet_tpu_torch.comm.allreduce import _row_sum

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    spec = comm.CompressionSpec("twobit")
    t = spec.threshold
    out = []
    for label, shape in TWOBIT_SHAPES.items():
        x = comm_rows(torch, gen, shape, COMM_CHUNK)
        q, dq, err = ck.quant_twobit(x, t, True, True)
        shard = ck.dequant_sum_twobit(q, t)
        cases = (
            ("quant_twobit", "q, err",
             lambda: ck.quant_twobit(x, t, want_err=True),
             lambda: ck.quant_twobit_plain(x, t, False, True),
             lambda: x - comm.decode(spec, comm.encode(spec, x)),
             [x], [q, err]),
            ("quant_twobit", "q, dq",
             lambda: ck.quant_twobit(x, t, True),
             lambda: ck.quant_twobit_plain(x, t, True),
             lambda: comm.decode(spec, comm.encode(spec, x)), [x], [q, dq]),
            ("dequant_sum_twobit", "shard",
             lambda: ck.dequant_sum_twobit(q, t),
             lambda: ck.dequant_sum_twobit_plain(q, t),
             lambda: _row_sum(comm.decode(spec, {"q": q})), [q], [shard]))
        for name, outputs, kernel, plain, codec, ins, outs in cases:
            r, _ = time_kernel_row(torch, registry, name, kernel, plain,
                                   codec, ins, outs)
            r = {"name": name, "at": label,
                 "shapes": [list(v.shape) for v in ins],
                 **kernel_form(ck, name, ins[0]), "outputs": outputs, **r,
                 "of_bound": r["bound_ms"] / r["ms"],
                 "launch_floor_ms": floor_ms,
                 "above_floor_ms": r["ms"] - floor_ms}
            out.append(r)
            emit({"phase": "kernel", **r})
        del x, q, dq, err, shard
    return out


def twobit_series(torch, ck, comm, registry, floor_ms):
    """The stage-1 quant_twobit (with its error) of each of dp_overlap's
    buckets, views of one flat buffer as the exchange takes them: all 31
    back to back between one event pair, then 31 empty launches
    (``torch.cuda._sleep(0)``) timed alike (whether the launch floor
    belongs to the event pair or to each launch); then each bucket
    alone."""
    from mxnet_tpu_torch.models import resnet50

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    t = comm.CompressionSpec("twobit").threshold
    net = resnet50(num_classes=1000)
    plan = comm.plan_overlap(resnet50_leaf_shapes(), "twobit", DP_WORLD,
                             max_bytes=DP_OVERLAP_BUCKET_BYTES, symbol=net)
    padded = [b["padded"] for b in plan.buckets]
    flat = comm_rows(torch, gen, (sum(padded),), COMM_CHUNK)
    views, off = [], 0
    for n in padded:
        views.append(flat[off:off + n].view(DP_WORLD, -1))
        off += n
    require(all(v.data_ptr() % 16 == 0 for v in views),
            "every bucket view starts 16-byte aligned")

    def series():
        for v in views:
            ck.quant_twobit(v, t, want_err=True)

    def sleeps():
        for _ in views:
            torch.cuda._sleep(0)

    series_ms = time_ms(torch, series, spin=SERIES_SPIN)
    sleeps_ms = time_ms(torch, sleeps, spin=SERIES_SPIN)
    alone, bounds, forms = [], [], []
    for v in views:
        alone.append(time_ms(torch, lambda: ck.quant_twobit(
            v, t, want_err=True)))
        q, _, err = ck.quant_twobit(v, t, want_err=True)
        bounds.append(registry.get_kernel("quant_twobit").cost(
            [v], [q, err]).bound()[0] * 1e3)
        forms.append(ck.quant_twobit_form(v))
    n = len(views)
    r = {"launches": n, "bucket_elems": padded, "series_ms": series_ms,
         "series_ms_per_launch": series_ms / n,
         "sleep_series_ms": sleeps_ms, "sleep_ms_per_launch": sleeps_ms / n,
         "launch_floor_ms": floor_ms, "alone_ms": alone,
         "alone_ms_sum": sum(alone), "bound_ms_sum": sum(bounds),
         "series_above_sleeps_ms": series_ms - sleeps_ms,
         "kernel_forms": forms}
    emit({"phase": "kernel", "name": "quant_twobit",
          "form": f"series: stage 1 of dp_overlap's {n} buckets back to "
                  "back between one event pair, with its error", **r})
    del flat, views
    return r


def digest_arrays(torch, *dicts):
    """sha256 of the values of name-keyed dicts of tensors or arrays, names
    sorted."""
    import hashlib

    h = hashlib.sha256()
    for d in dicts:
        for k in sorted(d, key=str):
            v = d[k]
            v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def dp_train_rank(torch, rank, world, mode):
    """One rank's dp_train run in ``mode``: ResNet-50 through
    ``fit(kvstore="dist_sync", compression=mode, comm_kernels=True)``, then
    one step split on the card's clock and one exchange run again on CPU
    copies. Returns numpy and Python values only."""
    import torch.distributed as dist

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import comm
    from mxnet_tpu_torch.comm import allreduce
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.kernels import comm_kernels as ck
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.models import resnet50

    net = resnet50(num_classes=1000)
    shape = (BATCH,) + IMAGE
    # each rank draws its own weights: rank 0's must reach every rank
    args, aux = random_params(net, SEED + rank, data=shape)
    rng = np.random.default_rng(SEED + 6)
    X = rng.standard_normal((world * BATCH,) + shape[1:], np.float32)
    Y = rng.integers(0, 1000, world * BATCH).astype(np.float32)
    X, Y = X[rank * BATCH:(rank + 1) * BATCH], Y[rank * BATCH:(rank + 1) * BATCH]
    # one fixed batch a rank every step: the run overfits it
    Xs = np.ascontiguousarray(np.broadcast_to(
        X, (DP_STEPS,) + shape).reshape((-1,) + shape[1:]))
    Ys = np.tile(Y, DP_STEPS)

    def digest(*dicts):
        return digest_arrays(torch, *dicts)

    sent, wire = [], allreduce._wire

    def counting_wire(op, out, inp, group):
        sent.append((op, inp.numel() * inp.element_size()))
        return wire(op, out, inp, group)

    kernels = {k.__name__: k for k in ck.KERNELS}
    kernels["fused_adam"] = kfa.fused_adam
    metric, stamps = step_loss_metric(mt), []
    comm.reset_comm_stats()
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="adam",
                           fused=True, learning_rate=LEARNING_RATE,
                           arg_params=args, aux_params=aux)
    torch.cuda.synchronize()
    allreduce._wire = counting_wire
    # the main path: every count is read around the fit
    for fn in kernels.values():
        fn.launches = 0
    model.fit(mt.io.NDArrayIter(Xs, Ys, batch_size=BATCH),
              kvstore="dist_sync", compression=mode, comm_kernels=True,
              eval_metric=metric,
              batch_end_callback=lambda p: stamps.append(time.perf_counter()))
    launches = {n: fn.launches for n, fn in kernels.items()}
    table = model._optimizer_obj._leaf_table
    allreduce._wire = wire
    by_op = {}
    for op, nbytes in sent:
        by_op[op] = by_op.get(op, 0) + nbytes
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    out = {"launches": launches, "losses": list(metric.steps),
           "step_ms": step_ms, "wire_bytes_by_op": by_op,
           "init_digest": digest(args, aux),
           "digest": digest(model.arg_params, model.aux_params),
           "finite": all(bool(torch.isfinite(v).all())
                         for v in model.arg_params.values()),
           "comm_stats_wire_bytes": comm.comm_stats()["wire_bytes"],
           "leaf_table": {"builds": table.builds,
                          "grad_uploads": table.grad_uploads}}

    # one step split on the card's clock, in 3 more steps after the fit with
    # synchronizes added: a barrier before the sync (the wait for the peer
    # rank, host clock); inside the sync the kernels (CUDA events around each
    # launch), the copies to and from pinned host buffers (host clock, card
    # synchronized around each) and the gloo calls (host clock)
    state, sync = model._train_state, model._train_state.grad_sync
    arrays = {"data": torch.from_numpy(X).cuda(),
              "softmax_label": torch.from_numpy(Y).cuda()}
    kernel_events, host_s = [], {}
    originals = {n: getattr(ck, n) for n in (k.__name__ for k in ck.KERNELS)}
    hosts = {"_to_host": "sync_d2h_ms", "_wire": "sync_gloo_ms",
             "_to_card": "sync_h2d_ms"}
    host_fns = {n: getattr(allreduce, n) for n in hosts}
    # the gradients are views of one flat buffer (C.1.4): the flatten is
    # pointing each .grad at its view before backward, the residual add is
    # autograd's accumulation into the buffer (inside backward_ms), the
    # unflatten the views of the exchange's result. Views launch no kernel:
    # their host clock, without synchronizes, is their whole cost
    views_fn = comm.flat_views

    def timed_views(*a, **kw):
        t0 = time.perf_counter()
        result = views_fn(*a, **kw)
        host_s["flat_views_ms"] += time.perf_counter() - t0
        return result

    def timed_kernel(fn):
        # wraps copies ``launches``: the wrapper's own count takes the adds
        @functools.wraps(fn)
        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            result = fn(*a, **kw)
            ev[1].record()
            kernel_events.append(ev)
            return result
        return run

    def timed_host(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*a, **kw)
            torch.cuda.synchronize()
            host_s[key] += time.perf_counter() - t0
            return result
        return run

    split = {k: [] for k in ("forward_ms", "backward_ms", "peer_wait_ms",
                             "sync_ms", "update_ms", "sync_kernels_ms",
                             "flat_views_ms", *hosts.values())}
    for name, fn in originals.items():
        setattr(ck, name, timed_kernel(fn))
    for name, key in hosts.items():
        setattr(allreduce, name, timed_host(host_fns[name], key))
    comm.flat_views = timed_views
    try:
        for _ in range(3):
            kernel_events.clear()
            host_s.update({k: 0.0 for k in (*hosts.values(),
                                             "flat_views_ms")})
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            state.prepare(LEARNING_RATE)
            ev[0].record()
            state.forward(arrays)
            ev[1].record()
            state.backward()
            ev[2].record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.barrier()
            split["peer_wait_ms"].append((time.perf_counter() - t0) * 1e3)
            ev[3].record()
            state.sync()
            ev[4].record()
            state.update()
            ev[5].record()
            torch.cuda.synchronize()
            for key, (a, b) in (("forward_ms", ev[0:2]),
                                ("backward_ms", ev[1:3]),
                                ("sync_ms", ev[3:5]), ("update_ms", ev[4:6])):
                split[key].append(a.elapsed_time(b))
            split["sync_kernels_ms"].append(
                sum(a.elapsed_time(b) for a, b in kernel_events))
            for key, seconds in host_s.items():
                split[key].append(seconds * 1e3)
    finally:
        for name, fn in originals.items():
            setattr(ck, name, fn)
        for name, fn in host_fns.items():
            setattr(allreduce, name, fn)
        comm.flat_views = views_fn
    out["split"] = {k: statistics.median(v) for k, v in split.items()}

    # the same exchange on a CPU copy of this step's flat buffer (the
    # gradients with the residual added): the kernels' plain versions and
    # the gloo exchange of CPU tensors
    state.forward(arrays)
    state.backward()
    total_cpu = sync.flat.cpu()
    state.sync()
    card = ({k: g.detach().cpu() for k, g in state.grads.items()},
            sync.residual.cpu())
    out_cpu, resid_cpu = comm.error_feedback_exchange(
        total_cpu, sync.spec, axis_size=world, kernels=sync.kernels)
    host = comm.flat_views(out_cpu, sync.shapes)
    # the copies the fit path no longer makes (the tree form's flatten,
    # residual add and unflatten), on this step's gradients, card's clock
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(3):
        flat, meta = allreduce._flatten(state.grads)
        total, size = allreduce._pad_flat(flat, sync.spec, world)
        allreduce._unflatten(total.add_(sync.residual[0])[:size], meta)
    ev[1].record()
    torch.cuda.synchronize()
    out["tree_copies_ms"] = ev[0].elapsed_time(ev[1]) / 3
    state.prepare(LEARNING_RATE)
    state.update()
    out["card_vs_cpu_sync_bitwise"] = (
        all(bits_equal(torch, card[0][k], host[k]) for k in card[0])
        and bits_equal(torch, card[1], resid_cpu))
    out["residual_abs_max"] = float(card[1].abs().max())
    del model, state, sync, arrays
    torch.cuda.empty_cache()
    return out


def dp_body(torch, rank, world):
    """dp_train's work on one rank: each mode in turn."""
    return {mode: dp_train_rank(torch, rank, world, mode)
            for mode in DP_MODES}


def rank_process(body, rank, world, init_method, timeout_s, queue):
    """A rank process of a multi-rank phase: joins the gloo group, runs
    ``body(torch, rank, world)`` and reports to the parent through
    ``queue``; it prints nothing."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from mxnet_tpu_torch import set_matmul_precision

        torch.cuda.set_device(0)
        torch.set_num_threads(4)
        set_matmul_precision("highest")
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        queue.put((rank, True, body(torch, rank, world)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(torch, body, world, timeout_s, what):
    """Start ``world`` rank processes that run ``body`` and share the card,
    and collect their results; a rank that fails or a run past the time
    limit kills every rank and raises. The ranks fork from one server
    process, started at the first call, that has imported this script,
    torch and the port but touched no CUDA: each rank starts in well under
    a second instead of importing torch anew, and makes its own CUDA
    context."""
    import multiprocessing as mp
    import os
    import queue as queue_mod
    from pathlib import Path

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rdv_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    rdv_dir.mkdir(parents=True, exist_ok=True)
    rdv = rdv_dir / f"rendezvous-{os.getpid()}"
    if rdv.exists():
        rdv.unlink()
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "torch", "torch.distributed",
                                "mxnet_tpu_torch"])
    queue = ctx.Queue()
    procs = [ctx.Process(target=rank_process, daemon=True,
                         args=(body, rank, world, f"file://{rdv}", timeout_s,
                               queue))
             for rank in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            require(left > 0, f"{what} ranks finished in {timeout_s} s")
            try:
                rank, ok, value = queue.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                require(not dead, f"{what} rank(s) {dead} died")
                continue
            require(ok, f"{what} rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        if rdv.exists():
            rdv.unlink()
    return [results[r] for r in range(world)]


def phase_dp_train(torch, comm):
    """ResNet-50 trained data-parallel on two ranks that share the card,
    int8 and twobit, through the comm kernels; checks and the time split.
    Returns the kernels' launches and each mode's median step ms."""
    ranks = run_ranks(torch, dp_body, DP_WORLD, DP_TIMEOUT_S, "dp_train")
    launches, medians = {}, {}
    for mode in DP_MODES:
        per_step = DP_LAUNCHES[mode]
        plan = comm.allreduce_plan(RESNET50_GRAD, DP_WORLD, mode)
        rows = {r["op"]: r for r in plan["collectives"]}
        for rank, res in enumerate(ranks):
            got = res[mode]
            for name, count in got["launches"].items():
                want = per_step.get(name, 0) * DP_STEPS
                require(count == want,
                        f"dp_train {mode} rank {rank}: {name} launched "
                        f"{count} times in {DP_STEPS} steps, expected {want}")
            by_op = got["wire_bytes_by_op"]
            require(by_op.get("all_to_all", 0) == DP_STEPS
                    * rows["all-to-all"]["payload_bytes"]
                    and by_op.get("all_gather", 0) * DP_WORLD == DP_STEPS
                    * rows["all-gather"]["payload_bytes"],
                    f"dp_train {mode} rank {rank}: wire bytes {by_op} against "
                    f"the plan {rows}")
            require(got["comm_stats_wire_bytes"] ==
                    DP_STEPS * plan["wire_bytes"],
                    f"dp_train {mode}: comm_stats against the plan")
            losses = got["losses"]
            require(len(losses) == DP_STEPS and np.isfinite(losses).all()
                    and losses[-1] < losses[0],
                    f"dp_train {mode} rank {rank}: the loss of its fixed "
                    f"batch fell: {losses}")
            require(got["finite"], f"dp_train {mode} rank {rank}: finite "
                    "parameters")
            require(got["leaf_table"]["builds"] == 1,
                    f"dp_train {mode} rank {rank}: fused_adam's leaf table "
                    f"built once in the fit: {got['leaf_table']}")
            require(got["card_vs_cpu_sync_bitwise"],
                    f"dp_train {mode} rank {rank}: the card's sync equals "
                    "the CPU's bitwise")
        require(len({r[mode]["digest"] for r in ranks}) == 1,
                f"dp_train {mode}: both ranks' parameters are bitwise equal")
        require(len({r[mode]["init_digest"] for r in ranks}) == DP_WORLD,
                "dp_train: the ranks drew different initial weights, so "
                "equal parameters show rank 0's broadcast")
        r0 = ranks[0][mode]
        median_ms = statistics.median(r0["step_ms"])
        wire_per_step = (DP_WORLD - 1) / DP_WORLD * (
            r0["wire_bytes_by_op"]["all_to_all"]
            + DP_WORLD * r0["wire_bytes_by_op"]["all_gather"]) / DP_STEPS
        emit({"phase": "dp_train", "mode": mode, "model": "resnet50",
              "world": DP_WORLD, "batch_per_rank": BATCH,
              "global_batch": DP_WORLD * BATCH, "steps": DP_STEPS,
              "optimizer": "adam", "fused": True, "comm_kernels": True,
              "transport": "gloo through pinned host buffers, both ranks "
                           "on one card",
              "launches": r0["launches"], "launches_per_step": DP_LAUNCHES[mode],
              "wire_bytes_per_step": wire_per_step,
              "plan_wire_bytes_per_step": plan["wire_bytes"],
              "fp32_wire_bytes_per_step": plan["fp32_wire_bytes"],
              "params_bitwise_equal_across_ranks": True,
              "card_vs_cpu_sync_bitwise": True,
              "residual_abs_max": r0["residual_abs_max"],
              "losses_rank0": r0["losses"],
              "losses_rank1": ranks[1][mode]["losses"],
              "step_ms": r0["step_ms"], "step_ms_median": median_ms,
              "global_images_per_s": DP_WORLD * BATCH * 1e3 / median_ms,
              "split_rank0": r0["split"],
              "split_rank1": ranks[1][mode]["split"],
              "tree_copies_ms_rank0": r0["tree_copies_ms"],
              "leaf_table_rank0": r0["leaf_table"]})
        for name, count in r0["launches"].items():
            if name != "fused_adam" and DP_LAUNCHES[mode].get(name):
                launches[name] = count
        medians[mode] = median_ms
    return launches, medians


def dp_rank_data(rank, world):
    """dp_train's ResNet-50, this rank's own initial weights (rank 0's
    must reach every rank) and its rows of one fixed batch, repeated for
    ``steps``."""
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.models import resnet50

    net = resnet50(num_classes=1000)
    shape = (BATCH,) + IMAGE
    args, aux = random_params(net, SEED + rank, data=shape)
    rng = np.random.default_rng(SEED + 6)
    X = rng.standard_normal((world * BATCH,) + shape[1:], np.float32)
    Y = rng.integers(0, 1000, world * BATCH).astype(np.float32)
    return net, args, aux, X[rank * BATCH:(rank + 1) * BATCH], \
        Y[rank * BATCH:(rank + 1) * BATCH]


def repeat_batch(X, Y, steps):
    shape = X.shape
    return (np.ascontiguousarray(np.broadcast_to(
        X, (steps,) + shape).reshape((-1,) + shape[1:])), np.tile(Y, steps))


def dp_overlap_rank(torch, rank, world, mode):
    """One rank's dp_overlap run in ``mode``: dp_train's fit with
    ``overlap=`` 4 MB buckets (the main path, counted), then the step, its
    compute alone (forward and backward of a one-device state on the same
    weights) and its exchange alone (every bucket of a filled buffer, one
    after another, on this thread), each on the host clock around a
    synchronized card; then one step whose buckets' inputs are kept, each
    exchanged again on a CPU copy. Returns numpy and Python values only."""
    import torch.distributed as dist

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import comm
    from mxnet_tpu_torch.comm import allreduce
    from mxnet_tpu_torch.kernels import comm_kernels as ck
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.model import _TrainState

    net, args, aux, X, Y = dp_rank_data(rank, world)
    Xs, Ys = repeat_batch(X, Y, DP_OVERLAP_STEPS)
    sent, wire = [], allreduce._wire

    def counting_wire(op, out, inp, group):
        sent.append((op, inp.numel() * inp.element_size()))
        return wire(op, out, inp, group)

    kernels = {k.__name__: k for k in ck.KERNELS}
    kernels["fused_adam"] = kfa.fused_adam
    metric, stamps = step_loss_metric(mt), []
    comm.reset_comm_stats()
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="adam",
                           fused=True, learning_rate=LEARNING_RATE,
                           arg_params=args, aux_params=aux)
    torch.cuda.synchronize()
    allreduce._wire = counting_wire
    # the main path: every count is read around the fit
    for fn in kernels.values():
        fn.launches = 0
    try:
        model.fit(mt.io.NDArrayIter(Xs, Ys, batch_size=BATCH),
                  kvstore="dist_sync", compression=mode, comm_kernels=True,
                  overlap=DP_OVERLAP_BUCKET_BYTES, eval_metric=metric,
                  batch_end_callback=lambda p: stamps.append(
                      time.perf_counter()))
    finally:
        allreduce._wire = wire
    launches = {n: fn.launches for n, fn in kernels.items()}
    by_op = {}
    for op, nbytes in sent:
        by_op[op] = by_op.get(op, 0) + nbytes
    state = model._train_state
    sync = state.grad_sync
    plan = sync.plan
    out = {"launches": launches, "losses": list(metric.steps),
           "step_ms": [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])],
           "wire_bytes_by_op": by_op, "num_buckets": plan.num_buckets,
           "layout_key": plan.layout_key(),
           "bucket_elems": plan.bucket_elems(),
           "init_digest": digest_arrays(torch, args, aux),
           "digest": digest_arrays(torch, model.arg_params, model.aux_params),
           "finite": all(bool(torch.isfinite(v).all())
                         for v in model.arg_params.values()),
           "comm_stats_wire_bytes": comm.comm_stats()["wire_bytes"],
           "leaf_table_builds": model._optimizer_obj._leaf_table.builds}

    # the step, its compute alone and its exchange alone, 3 times each
    arrays = {"data": torch.from_numpy(X).cuda(),
              "softmax_label": torch.from_numpy(Y).cuda()}
    # the schedule is rebuilt below, after fit closed it
    sync.schedule = comm.OverlapSchedule(plan, state.device,
                                         kernels=sync.kernels)
    sched = sync.schedule
    solo = _TrainState(net, model._optimizer_obj,
                       {k: v.detach().clone() for k, v in state.params.items()},
                       {k: v.clone() for k, v in state.aux.items()},
                       state.device, apply_update=False)
    timing = {"step_ms": [], "compute_ms": [], "comm_ms": []}

    def clocked(key, fn):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        timing[key].append((time.perf_counter() - t0) * 1e3)

    def whole_step():
        state.prepare(LEARNING_RATE)
        state.forward(arrays)
        state.backward()
        state.sync()
        state.update()

    def compute():
        solo.forward(arrays)
        solo.backward()

    def exchange_alone():
        buf = sched.flat.clone()
        for i, b in enumerate(plan.buckets):
            off = sched.offsets[i]
            comm.error_feedback_exchange(buf[off:off + b["padded"]],
                                         plan.spec, None, world,
                                         sync.kernels)

    for _ in range(3):
        clocked("step_ms", whole_step)
        clocked("compute_ms", compute)
        clocked("comm_ms", exchange_alone)
    del solo
    split = {k: statistics.median(v) for k, v in timing.items()}
    split["overlap_efficiency"] = comm.overlap_efficiency(
        split["step_ms"], split["compute_ms"], split["comm_ms"])
    out["split"], out["split_runs"] = split, timing

    # one more step, each bucket's input (its gradients with the residual
    # added, read on the side stream after its event) kept; then the same
    # exchange of a CPU copy of each: the kernels' plain versions, gloo on
    # CPU tensors
    inputs, run_exchange = {}, sched._run_exchange
    forms, aligned = set(), []

    def keep_input(flats, n):
        (flat,) = flats  # this rank's bucket
        inputs[len(inputs)] = flat.clone()
        # the form stage 1 takes on this bucket's view, and its alignment
        rows = flat.reshape(n, -1)
        forms.add(ck.quant_int8_form(rows, COMM_CHUNK) if mode == "int8"
                  else ck.quant_twobit_form(rows))
        aligned.append(rows.data_ptr() % 16 == 0)
        return run_exchange(flats, n)

    sched._run_exchange = keep_input
    state.prepare(LEARNING_RATE)
    state.forward(arrays)
    state.backward()
    grads = sched.wait()
    torch.cuda.synchronize()
    sched._run_exchange = run_exchange
    bitwise, checked = True, 0
    for i, b in enumerate(plan.buckets):
        cpu_out, cpu_res = comm.error_feedback_exchange(
            inputs[i].cpu(), plan.spec, None, world, sync.kernels)
        want = comm.flat_views(cpu_out, sched.shapes[i])
        bitwise &= all(bits_equal(torch, grads[k].cpu(), want[k])
                       for k in b["keys"])
        bitwise &= bits_equal(torch, sched.bucket_slice(i).cpu(),
                              cpu_res[0])
        checked += 1
    sched.close()
    out["card_vs_cpu_buckets_bitwise"] = bitwise
    out["buckets_checked"] = checked
    out["stage1_quant_forms"] = sorted(forms)
    out["stage1_views_aligned"] = all(aligned)
    out["residual_abs_max"] = float(sched.flat.abs().max())
    del model, state, sync, sched, arrays, grads, inputs
    torch.cuda.empty_cache()
    return out


def dp_overlap_body(torch, rank, world):
    return {mode: dp_overlap_rank(torch, rank, world, mode)
            for mode in DP_MODES}


def phase_dp_overlap(torch, comm, dp_medians, bucket_rows):
    """dp_train's run with the gradient exchanged bucket by bucket while
    backward runs; checks and the step against dp_train's fused step.
    ``bucket_rows``: the comm kernels' times at one bucket's shape."""
    from mxnet_tpu_torch.kernels import comm_kernels as ck

    ranks = run_ranks(torch, dp_overlap_body, DP_WORLD, DP_TIMEOUT_S,
                      "dp_overlap")
    # rank 0's counts, both modes' runs together
    launches = {n: 0 for n in port_kernels()}
    for mode in DP_MODES:
        r0 = ranks[0][mode]
        plan = comm.overlap_plan(r0["bucket_elems"], DP_WORLD, mode)
        rows = {r["op"]: r for r in plan["collectives"]}
        buckets = r0["num_buckets"]
        plan_padded = [comm.padded_flat_size(num, comm.CompressionSpec(mode),
                                             DP_WORLD)
                       for _, num in r0["bucket_elems"]]
        for rank, res in enumerate(ranks):
            got = res[mode]
            require(got["layout_key"] == r0["layout_key"],
                    f"dp_overlap {mode}: the ranks planned alike")
            for name, count in got["launches"].items():
                per = DP_LAUNCHES[mode].get(name, 0)
                want = DP_OVERLAP_STEPS * (per if name == "fused_adam"
                                           else per * buckets)
                require(count == want,
                        f"dp_overlap {mode} rank {rank}: {name} launched "
                        f"{count} times in {DP_OVERLAP_STEPS} steps of "
                        f"{buckets} buckets, expected {want}")
            by_op = got["wire_bytes_by_op"]
            require(by_op.get("all_to_all", 0) == DP_OVERLAP_STEPS
                    * rows["all-to-all"]["payload_bytes"]
                    and by_op.get("all_gather", 0) * DP_WORLD
                    == DP_OVERLAP_STEPS * rows["all-gather"]["payload_bytes"],
                    f"dp_overlap {mode} rank {rank}: wire bytes {by_op} "
                    f"against overlap_plan {rows}")
            require(got["comm_stats_wire_bytes"] ==
                    DP_OVERLAP_STEPS * plan["wire_bytes"],
                    f"dp_overlap {mode}: comm_stats against overlap_plan")
            losses = got["losses"]
            require(len(losses) == DP_OVERLAP_STEPS
                    and np.isfinite(losses).all() and losses[-1] < losses[0],
                    f"dp_overlap {mode} rank {rank}: the loss of its fixed "
                    f"batch fell: {losses}")
            require(got["finite"], f"dp_overlap {mode} rank {rank}: finite "
                    "parameters")
            require(got["leaf_table_builds"] == 1,
                    f"dp_overlap {mode} rank {rank}: fused_adam's leaf table "
                    "built once in the fit")
            require(got["card_vs_cpu_buckets_bitwise"]
                    and got["buckets_checked"] == buckets,
                    f"dp_overlap {mode} rank {rank}: each bucket's synced "
                    "gradients and residual on the card equal the CPU "
                    "exchange of the same bucket, bitwise")
            # the buckets are padded to the quantization unit times the
            # ranks, so every bucket view starts 16-byte aligned: int8
            # takes its chunked form on every bucket, twobit its vector
            # form on every bucket of QUANT_TWOBIT_VECTOR_MIN elements
            want_forms = ["chunked"] if mode == "int8" else sorted(
                {"vector" if b >= ck.QUANT_TWOBIT_VECTOR_MIN else "scalar"
                 for b in plan_padded})
            require(got["stage1_views_aligned"]
                    and got["stage1_quant_forms"] == want_forms,
                    f"dp_overlap {mode} rank {rank}: stage 1's forms "
                    f"{got['stage1_quant_forms']} on aligned views "
                    f"({got['stage1_views_aligned']}), expected {want_forms}")
        require(len({r[mode]["digest"] for r in ranks}) == 1,
                f"dp_overlap {mode}: both ranks' parameters are bitwise "
                "equal")
        median_ms = statistics.median(r0["step_ms"])
        emit({"phase": "dp_overlap", "mode": mode, "model": "resnet50",
              "world": DP_WORLD, "batch_per_rank": BATCH,
              "steps": DP_OVERLAP_STEPS, "optimizer": "adam", "fused": True,
              "comm_kernels": True,
              "bucket_bytes": DP_OVERLAP_BUCKET_BYTES, "buckets": buckets,
              "bucket_elems": r0["bucket_elems"],
              "transport": "gloo through pinned host buffers, both ranks "
                           "on one card",
              "limit": "both ranks share one card and gloo copies through "
                       "host memory, so the exchange and backward compete "
                       "for one card and its host: overlap's gain cannot "
                       "show here (C.1.5)",
              "launches": r0["launches"],
              "launches_per_step_per_bucket": DP_LAUNCHES[mode],
              "plan_wire_bytes_per_step": plan["wire_bytes"],
              "plan_matches_fused": plan["matches_fused"],
              "padded_elements": plan["padded_elements"],
              "params_bitwise_equal_across_ranks": True,
              "card_vs_cpu_buckets_bitwise": True,
              "stage1_quant_forms": r0["stage1_quant_forms"],
              "residual_abs_max": r0["residual_abs_max"],
              "losses_rank0": r0["losses"],
              "losses_rank1": ranks[1][mode]["losses"],
              "step_ms": r0["step_ms"], "step_ms_median": median_ms,
              "dp_train_fused_step_ms_median": dp_medians[mode],
              "global_images_per_s": DP_WORLD * BATCH * 1e3 / median_ms,
              "split_rank0": r0["split"], "split_rank1": ranks[1][mode]["split"],
              "split_runs_rank0": r0["split_runs"]})
        for name, count in r0["launches"].items():
            launches[name] += count
            if name in bucket_rows and DP_LAUNCHES[mode].get(name):
                bucket_rows[name]["launches_overlap"] = count
    return launches


def record_async(kvs_mod, records):
    """Wrap the dist_async store's round trips to keep, in ``records``,
    the optimizer blob sent to the host, each ``push_pull``'s gradients
    and the digest of its returned weights, each ``push_pull_stale``'s and
    ``flush_stale``'s returned weights' digests, and the store itself.
    Returns the originals, for :func:`unrecord_async`."""
    import pickle

    import torch

    cls = kvs_mod.AsyncKVStore
    orig = {n: getattr(cls, n) for n in ("__init__", "set_optimizer",
                                         "push_pull", "push_pull_stale",
                                         "flush_stale")}

    def init(self):
        orig["__init__"](self)
        records["store"] = self

    def set_optimizer(self, optimizer):
        records["optimizer"] = pickle.dumps(optimizer)
        return orig["set_optimizer"](self, optimizer)

    def push_pull(self, kvs, priority=0):
        if records.get("keep_grads"):
            records["grads"].append({k: np.array(v, copy=True)
                                     for k, v in kvs.items()})
        out = orig["push_pull"](self, kvs, priority)
        records["push_pull"].append(digest_arrays(torch, out))
        return out

    def push_pull_stale(self, kvs):
        out = orig["push_pull_stale"](self, kvs)
        records["stale"].append(digest_arrays(torch, out))
        return out

    def flush_stale(self, keys):
        out = orig["flush_stale"](self, keys)
        records["flush"].append(digest_arrays(torch, out))
        return out

    for n, fn in (("__init__", init), ("set_optimizer", set_optimizer),
                  ("push_pull", push_pull),
                  ("push_pull_stale", push_pull_stale),
                  ("flush_stale", flush_stale)):
        setattr(cls, n, fn)
    records.update(grads=[], push_pull=[], stale=[], flush=[])
    return orig


def unrecord_async(kvs_mod, orig):
    for n, fn in orig.items():
        setattr(kvs_mod.AsyncKVStore, n, fn)


def dp_async_fit(torch, mt, net, args, aux, X, Y, records, **fit_kw):
    """``fit(kvstore="dist_async")`` of DP_ASYNC_STEPS steps on one fixed
    batch, round trips recorded; then the forward and backward alone on the
    card's clock (median of 3). Returns the model and its row."""
    from mxnet_tpu_torch import kvstore_async

    Xs, Ys = repeat_batch(X, Y, DP_ASYNC_STEPS)
    metric, stamps = step_loss_metric(mt), []
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1,
                           arg_params=args, aux_params=aux, **DP_ASYNC_OPT)
    orig = record_async(kvstore_async, records)
    try:
        model.fit(mt.io.NDArrayIter(Xs, Ys, batch_size=BATCH),
                  kvstore="dist_async", eval_metric=metric,
                  batch_end_callback=lambda p: stamps.append(
                      time.perf_counter()), **fit_kw)
    finally:
        unrecord_async(kvstore_async, orig)
    state = model._train_state
    arrays = {"data": torch.from_numpy(X).cuda(),
              "softmax_label": torch.from_numpy(Y).cuda()}
    device_ms = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state.forward(arrays)
        state.backward()
        ev[1].record()
        torch.cuda.synchronize()
        device_ms.append(ev[0].elapsed_time(ev[1]))
    rounds = model.async_rounds
    row = {"losses": list(metric.steps),
           "step_ms": [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])],
           "device_ms_median": statistics.median(device_ms),
           "round_trip_ms": {k[:-2] + "_ms": statistics.median(
               r[k] * 1e3 for r in rounds[1:]) for k in rounds[0]},
           "update_on_host": model._train_state.apply_update is False,
           "finite": all(bool(torch.isfinite(v).all())
                         for v in model.arg_params.values())}
    row["step_ms_median"] = statistics.median(row["step_ms"])
    return model, row


def dp_async_rank(torch, rank, world, *, port):
    """One of two dist_async workers sharing the card: int8 pushes to rank
    0's host. Each waits for the other after its fit; rank 0 then reads the
    host's counters."""
    import os

    import mxnet_tpu_torch as mt

    os.environ.update(MXTPU_WORKER_RANK=str(rank),
                      MXTPU_NUM_WORKERS=str(world),
                      MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                      MXTPU_ASYNC_PORT=str(port))
    net, args, aux, X, Y = dp_rank_data(rank, world)
    records = {}
    _, row = dp_async_fit(torch, mt, net, args, aux, X, Y, records,
                          compression="int8")
    kv = records["store"]
    kv.barrier()  # every push has landed
    row["compression"] = kv.compression_stats()
    row["host"] = kv.stats() if rank == 0 else None
    kv.barrier()  # rank 0 read the host before anyone leaves
    kv.close()
    return row


def phase_dp_async(torch, mt):
    """ResNet-50 at batch 32, f32, through ``fit(kvstore="dist_async")``:
    the host's replay, two workers with int8 pushes, stale sync."""
    import pickle
    import socket

    from mxnet_tpu_torch import kvstore as tkv
    from mxnet_tpu_torch import optimizer as topt

    net, args, aux, batch_x, batch_y = resnet50_case()
    reset_launches()
    # the main path: one worker, SGD on the host
    records = {"keep_grads": True}
    model, one = dp_async_fit(torch, mt, net, args, aux, batch_x, batch_y,
                              records)
    launches = read_launches()
    eager = mt._compile.compile_stats()["eager"]
    # the host's own replay: its optimizer, unpickled as the host did, over
    # the recorded gradients, from the initial weights
    update = tkv.wrap_np_updater(topt.get_updater(
        pickle.loads(records["optimizer"])))
    store = {k: np.array(v, np.float32) for k, v in args.items()}
    for grads in records["grads"]:
        for k, g in grads.items():
            update(k, g, store[k])
    replay = all(bits_equal(torch, model.arg_params[k].cpu(),
                            torch.from_numpy(store[k])) for k in store)
    require(len(records["grads"]) == DP_ASYNC_STEPS,
            f"dp_async: {DP_ASYNC_STEPS} pushes, {len(records['grads'])}")
    require(replay, "dp_async: the worker's final weights are bitwise the "
            "host's updates replayed over the gradients it pushed")
    require(one["finite"] and one["losses"][-1] < one["losses"][0],
            f"dp_async: the loss of the fixed batch fell: {one['losses']}")
    require(one["update_on_host"] and any("dist_async" in r for r in eager),
            f"dp_async: the step only takes the gradients, eager by name: "
            f"{eager}")
    del model, records, store

    # stale sync: each step gets the weights one round behind
    records = {}
    model, stale = dp_async_fit(torch, mt, net, args, aux, batch_x, batch_y,
                                records, overlap=True)
    pp, st, fl = records["push_pull"], records["stale"], records["flush"]
    require(len(st) == DP_ASYNC_STEPS and len(pp) == DP_ASYNC_STEPS
            and st[0] == digest_arrays(torch, args)
            and st[1:] == pp[:-1] and fl == [pp[-1]],
            "dp_async stale: step k got round k-1's weights (step 0 the "
            "initial ones) and flush_stale drained the last round")
    require(stale["finite"] and stale["losses"][-1] < stale["losses"][0],
            f"dp_async stale: the loss fell: {stale['losses']}")
    del model, records

    # two workers sharing the card, int8 pushes
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ranks = run_ranks(torch, functools.partial(dp_async_rank, port=port),
                      DP_ASYNC_WORLD, DP_ASYNC_TIMEOUT_S, "dp_async")
    host = ranks[0]["host"]
    sent = sum(r["compression"]["bytes_encoded"] for r in ranks)
    raw = sum(r["compression"]["bytes_raw"] for r in ranks)
    require(host["update_count"] == DP_ASYNC_WORLD * DP_ASYNC_STEPS,
            f"dp_async: the host applied {host['update_count']} pushes, "
            f"{DP_ASYNC_WORLD} x {DP_ASYNC_STEPS} expected")
    require(host["wire_bytes_received"] == sent > 0
            and host["raw_bytes_received"] == raw,
            f"dp_async: HostCodec's sent bytes {sent} (raw {raw}) are the "
            f"host's received {host}")
    require(all(r["finite"] for r in ranks), "dp_async: finite weights")
    emit({"phase": "dp_async", "model": "resnet50", "batch": BATCH,
          "dtype": "float32", "steps": DP_ASYNC_STEPS, **DP_ASYNC_OPT,
          "one_worker": one, "host_replay_bitwise": True,
          "stale_sync": {**stale, "one_round_behind": True,
                         "flush_drains": True},
          "two_workers": {"int8": True, "host": host,
                          "sent_bytes": sent, "raw_bytes": raw,
                          "rank0": {k: ranks[0][k] for k in
                                    ("losses", "step_ms_median",
                                     "device_ms_median", "round_trip_ms")},
                          "rank1": {k: ranks[1][k] for k in
                                    ("losses", "step_ms_median",
                                     "device_ms_median", "round_trip_ms")}},
          "launches": launches})
    return launches



def lm_mesh_tokens(vocab):
    """The global batch of lm_mesh (8 x 2048 tokens), the same on every
    rank and in the parent."""
    return lm_tokens(np.random.default_rng(SEED + 7), LM_BATCH, LM_SEQ, vocab)


def lm_mesh_faults(torch, mt, model, mesh, params, tokens, targets):
    """The first step's parameters ``params`` (this rank's blocks) read as
    they are and with one fault planted at a time, each a layout the port
    could get wrong and still run: for each, the loss of the fixed global
    batch (``tokens``, ``targets``) and the relative Frobenius error of this
    rank's block of the logits against the single-rank forward's. On tp >
    1, ``wqkv`` cut in tp contiguous column blocks (the JAX spec read
    literally) where the port cuts it by heads; on sp > 1, every rank's
    positions read from row 0 of ``pos_embed``, and the ring's off-diagonal
    block run under the causal mask. The code is not changed: the
    parameters are, or the ring's call of the forward kernel is wrapped for
    the one reading."""
    from mxnet_tpu_torch.parallel import data_sharding, sequence

    whole = model.init_params(SEED, ctx=mt.cpu())
    data = data_sharding(mesh, "sp")
    tok, tgt = data.shard(tokens), data.shard(targets)
    with torch.no_grad():
        want = data.shard(model.forward(
            {k: v.to(mesh.device) for k, v in whole.items()},
            torch.from_numpy(tokens).to(mesh.device)))

    def read(p):
        with torch.no_grad():
            logits = model.forward(p, tok, mesh)
            err = float(torch.linalg.vector_norm(logits - want)
                        / torch.linalg.vector_norm(want))
            del logits
            return {"loss": float(model.loss(p, tok, tgt, mesh)),
                    "logits_rel_err": err}

    out = {"sound": read(params)}
    if mesh.shape.get("tp", 1) > 1:
        tp, cut = mesh.axis("tp"), dict(params)
        for k, w in whole.items():
            if k.endswith("_wqkv"):
                n = w.shape[1] // tp.size
                cut[k] = w[:, tp.index * n:(tp.index + 1) * n].to(params[k])
        out["wqkv_contiguous"] = read(cut)
    if mesh.shape.get("sp", 1) > 1:
        start = mesh.axis("sp").index * tok.shape[1]
        out["pos_embed_from_0"] = read(dict(
            params, pos_embed=torch.roll(params["pos_embed"], start, 0)))
        fwd = sequence.flash_attention_with_lse
        sequence.flash_attention_with_lse = (
            lambda q, k, v, causal=False: fwd(q, k, v, causal=True))
        try:
            out["off_diagonal_causal"] = read(params)
        finally:
            sequence.flash_attention_with_lse = fwd
    del want
    return out


def split_step(torch, run):
    """The split of one step on the card's clock: ``run(mark)`` runs the
    step, which calls ``mark(phase)`` as each phase ends (the step's own
    marks, not a copy of its body), and each phase's time is read between
    CUDA events; the gloo calls inside (the card synchronized before each)
    are timed apart on the host's clock as ``gloo_ms``."""
    import types

    import torch.distributed as dist

    from mxnet_tpu_torch.comm import allreduce

    gloo_s = [0.0]
    wire, p2p = allreduce._wire, dist.batch_isend_irecv

    def timed_wire(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wire(*a, **kw)
        gloo_s[0] += time.perf_counter() - t0

    def timed_p2p(ops):
        # the batch's requests, each still waited on once by its caller;
        # the time from the post to the last wait is added
        torch.cuda.synchronize()
        last = [time.perf_counter()]

        def timed(req):
            def wait(*a, **kw):
                done = req.wait(*a, **kw)
                now = time.perf_counter()
                gloo_s[0] += now - last[0]
                last[0] = now
                return done
            return types.SimpleNamespace(wait=wait)
        return [timed(req) for req in p2p(ops)]

    events = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(phase):
        events.append((phase, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    allreduce._wire, dist.batch_isend_irecv = timed_wire, timed_p2p
    try:
        events[0][1].record()
        run(mark)
        torch.cuda.synchronize()
    finally:
        allreduce._wire, dist.batch_isend_irecv = wire, p2p
    split = {f"{phase}_ms": a.elapsed_time(b)
             for (_, a), (phase, b) in zip(events, events[1:])}
    split["gloo_ms"] = gloo_s[0] * 1e3
    return split


def lm_mesh_train(torch, rank, sizes):
    """One rank's run of the full-width LM on a mesh: LM_MESH_STEPS steps of
    ``make_train_step(mesh, optimizer=Adam(fused=True))`` on its blocks of
    the fixed global batch, the launches counted around them; the first
    step's loss with faults planted (:func:`lm_mesh_faults`); then one more
    step split on the card's clock (the step's own ``mark``), the gloo
    calls timed apart on the host's. Returns numpy and Python values
    only."""
    import hashlib

    import torch.distributed as dist

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.kernels import flash_attention as tfa
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.models import TransformerLM, transformer_lm_config
    from mxnet_tpu_torch.parallel import data_sharding, make_mesh

    mesh = make_mesh(**sizes, devices=mt.gpu(0))
    cfg = transformer_lm_config()
    model = TransformerLM(cfg)
    opt = topt.create("adam", learning_rate=LEARNING_RATE, fused=True)
    params, state = model.init_sharded(mesh, seed=SEED, optimizer=opt)
    params0 = {k: v.clone() for k, v in params.items()}
    data = data_sharding(mesh, "sp")
    tok, tgt = (data.shard(t) for t in lm_mesh_tokens(cfg["vocab_size"]))
    step = model.make_train_step(mesh, optimizer=opt)
    kernels = {n: getattr(tfa, n) for n in FLASH_NAMES}
    kernels["fused_adam"] = kfa.fused_adam
    torch.cuda.synchronize()
    dist.barrier()
    # the main path: every count is read around the steps
    for fn in kernels.values():
        fn.launches = 0
    losses, stamps = [], [time.perf_counter()]
    for _ in range(LM_MESH_STEPS):
        params, state, loss = step(params, state, tok, tgt)
        losses.append(float(loss))   # syncs the host with the step
        stamps.append(time.perf_counter())
    launches = {n: fn.launches for n, fn in kernels.items()}
    out = {
        "launches": launches, "losses": losses,
        "step_ms": [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])],
        "local_tokens": list(tok.shape),
        "finite": all(bool(torch.isfinite(v).all()) for v in params.values()),
        "moved": all(not torch.equal(v, params0[k])
                     for k, v in params.items()),
        "digests": {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
                    for k, v in params.items()},
        "faults": lm_mesh_faults(torch, mt, model, mesh, params0,
                                 *lm_mesh_tokens(cfg["vocab_size"]))}
    del params0

    # one more step, split on the card's clock by the step's own marks
    out["split"] = split_step(torch, lambda mark: step(params, state, tok,
                                                       tgt, mark=mark))
    torch.cuda.empty_cache()
    return out


def lm_mesh_ring(torch, rank):
    """Ring flash attention alone at the LM's attention split over sp = 2
    (8 x 8 x 1024 x 64 bf16 a rank, causal): the output and dq, dk, dv,
    gathered on rank 0 and held row by row within ``flash_row_bound``
    against references computed from the global q, k, v alone, never from
    the ring's results. Gated: o and dv against ``attention_reference`` in
    f32 and its gradient; dk against the f32 gradient whose ``delta =
    rowsum(do * o)`` takes o as the reference output rounded once to bf16;
    o, dq, dk and dv against the plain versions of the single-card kernels
    (``flash_fwd_plain``, then ``attention_delta`` of its output, then
    ``flash_bwd_plain``), which round p and ds to bf16 where the kernels do.

    Printed only: dq and dk against ``attention_reference``'s own gradient,
    and dq against the f32 gradient with the rounded delta. Flash
    attention's backward (the JAX kernels' too) takes delta from its own
    bf16 output, whose p was rounded to bf16 before the product with v;
    where ``dp - delta`` cancels (a query that sees a few keys) that
    rounding moves dq by more than 2^-7 of its norm against the f32
    gradient, on one card as on the ring (``ROADMAP.md`` C.2)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.kernels.flash_attention import (
        attention_delta, flash_bwd_plain, flash_fwd_plain)
    from mxnet_tpu_torch.parallel import (attention_reference, make_mesh,
                                          ring_flash_attention)
    from mxnet_tpu_torch.parallel.mesh import P, Sharding

    mesh = make_mesh(sp=2, devices=mt.gpu(0))
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 8)
    shape = (LM_BATCH, 8, LM_SEQ, 64)
    q, k, v, do = (torch.randn(shape, generator=gen, device=mesh.device)
                   .to(torch.bfloat16) for _ in range(4))
    block = Sharding(mesh, P(None, None, "sp", None))
    ql, kl, vl = (block.shard(t).requires_grad_(True) for t in (q, k, v))
    o = ring_flash_attention(ql, kl, vl, mesh.axis("sp"), causal=True)
    grads = torch.autograd.grad(o, (ql, kl, vl), block.shard(do))
    got = dict(zip(("o", "dq", "dk", "dv"),
                   (block.gather(t) for t in (o.detach(), *grads))))
    del o, grads, ql, kl, vl
    if rank != 0:
        return {}
    bound = flash_row_bound(torch, torch.bfloat16)
    errors, gated = {}, []

    def hold(name, of, want, gate):
        share, rel = row_errors(torch, got[of], want, bound)
        errors[name] = {"share_of_bound_max": float(share.max()),
                        "rows_over_bound": int((share > 1).sum()),
                        "row_rel_err_max": float(rel.max()),
                        "row_rel_err_median": float(rel.median()),
                        "max_abs_err": float((got[of].float() - want.float())
                                             .abs().max())}
        if gate:
            gated.append(name)

    po, plse = flash_fwd_plain(q, k, v, True)
    plain = flash_bwd_plain(q, k, v, do, plse, attention_delta(po, do), True)
    hold("o_plain", "o", po, True)
    for name, want in zip(("dq", "dk", "dv"), plain):
        hold(f"{name}_plain", name, want, True)
    del po, plse, plain
    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    ref = attention_reference(qf, kf, vf, causal=True)
    rdq, rdk, rdv = torch.autograd.grad(ref, (qf, kf, vf), do.float())
    hold("o", "o", ref.detach(), True)
    hold("dv", "dv", rdv, True)
    hold("dq_f32", "dq", rdq, False)
    hold("dk_f32", "dk", rdk, False)
    del rdq, rdk, rdv
    with torch.no_grad():
        root_d = torch.tensor(np.sqrt(np.float32(shape[3])),
                              device=mesh.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / root_d
        seq = torch.arange(shape[2], device=mesh.device)
        p = torch.softmax(torch.where(seq[:, None] >= seq[None, :], s,
                                      float("-inf")), dim=-1)
        del s
        dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
        delta = attention_delta(ref.detach().to(torch.bfloat16), do)
        ds = p * (dp - delta[..., None]) / root_d
        del p, dp
        hold("dq_f32_bf16_delta", "dq", ds @ kf, False)
        hold("dk_f32_bf16_delta", "dk", ds.transpose(-1, -2) @ qf, True)
        del ds
    return {"shape": list(shape), "errors": errors, "row_rel_bound": bound,
            "row_floor_of_rms": ROW_FLOOR, "gated": gated}


def lm_mesh_body(torch, rank, world):
    """lm_mesh's work on one rank: the meshes in turn, then the ring."""
    out = {name: lm_mesh_train(torch, rank, sizes)
           for name, sizes in LM_MESHES.items()}
    out["ring"] = lm_mesh_ring(torch, rank)
    return out


def lm_mesh_launches(name, rank, n_layers):
    """Launches a step of each kernel on ``rank`` of mesh ``name``: on
    sp = 2, rank 0 computes its diagonal block and skips the later one
    (one flash call of each kind a layer), rank 1 computes both."""
    blocks = rank + 1 if name == "sp2" else 1
    return {**{n: blocks * n_layers for n in FLASH_NAMES}, "fused_adam": 1}


def phase_lm_mesh(torch, mt, params):
    """The full-width LM trained on two meshes of two ranks sharing the card
    (sp = 2 and tp = 2), and ring flash attention alone, with their checks;
    returns each kernel's launches per mesh and rank."""
    from mxnet_tpu_torch.models import TransformerLM, transformer_lm_config
    from mxnet_tpu_torch.parallel.tensor_parallel import (
        transformer_param_specs)

    cfg = transformer_lm_config()
    model = TransformerLM(cfg)
    tokens, targets = (torch.from_numpy(t).cuda()
                       for t in lm_mesh_tokens(cfg["vocab_size"]))
    # the single-rank step's loss from the same parameters (init_params of
    # the same seed: the ranks' init_sharded cuts exactly these)
    with torch.no_grad():
        ref_loss = float(model.loss(params, tokens, targets))
    del tokens, targets
    ranks = run_ranks(torch, lm_mesh_body, LM_MESH_WORLD, LM_MESH_TIMEOUT_S,
                      "lm_mesh")
    specs = transformer_param_specs(cfg["n_layers"])
    ring = ranks[0]["ring"]
    emit({"phase": "lm_mesh_ring", **ring})
    launches = {}
    for name, sizes in LM_MESHES.items():
        runs = [r[name] for r in ranks]
        err = abs(runs[0]["losses"][0] - ref_loss) / ref_loss
        # each reading: the loss's relative error (the same on both ranks)
        # and the larger of the two ranks' logits errors
        readings = {f: {"loss_rel_err": abs(r["loss"] - ref_loss) / ref_loss,
                        "logits_rel_err": max(run["faults"][f][
                            "logits_rel_err"] for run in runs)}
                    for f, r in runs[0]["faults"].items()}
        faults = {f: r for f, r in readings.items() if f != "sound"}
        # leaves a mesh axis replicates: bitwise equal on the ranks that
        # hold them (on sp = 2 every leaf; on tp = 2 those not split on tp)
        split = {k for k, spec in specs.items() if "tp" in spec} \
            if sizes.get("tp", 1) > 1 else set()
        replicated = [k for k in runs[0]["digests"] if k not in split]
        median_ms = statistics.median(runs[0]["step_ms"])
        emit({"phase": "lm_mesh", "mesh": name,
              "mesh_shape": {"dp": 1, **sizes}, "world": LM_MESH_WORLD,
              "transport": "gloo through pinned host buffers, both ranks "
                           "on one card",
              "global_batch": [LM_BATCH, LM_SEQ],
              "local_tokens": runs[0]["local_tokens"],
              "steps": LM_MESH_STEPS, "optimizer": "adam", "fused": True,
              "learning_rate": LEARNING_RATE,
              "launches": [r["launches"] for r in runs],
              "launches_per_step": [lm_mesh_launches(name, r, cfg["n_layers"])
                                    for r in range(LM_MESH_WORLD)],
              "first_loss": runs[0]["losses"][0],
              "single_rank_loss": ref_loss, "first_loss_rel_err": err,
              "bound": LM_MESH_LOSS_BOUND,
              "logits_bound": LM_MESH_LOGITS_BOUND,
              "sound_and_planted_faults": readings,
              "faults_by_rank": [r["faults"] for r in runs],
              "losses": runs[0]["losses"],
              "replicated_leaves_bitwise_equal": len(replicated),
              "step_ms": runs[0]["step_ms"], "step_ms_median": median_ms,
              "global_tokens_per_s": LM_BATCH * LM_SEQ * 1e3 / median_ms,
              "split_rank0": runs[0]["split"],
              "split_rank1": runs[1]["split"]})
        for rank, run in enumerate(runs):
            want = lm_mesh_launches(name, rank, cfg["n_layers"])
            for kernel, per_step in want.items():
                require(run["launches"][kernel] == per_step * LM_MESH_STEPS,
                        f"lm_mesh {name} rank {rank}: {kernel} launched "
                        f"{run['launches'][kernel]} times in {LM_MESH_STEPS} "
                        f"steps, expected {per_step} a step")
            losses = run["losses"]
            require(np.isfinite(losses).all() and losses[-1] < losses[0],
                    f"lm_mesh {name} rank {rank}: the loss of the fixed "
                    f"batch fell: {losses}")
            require(run["finite"] and run["moved"],
                    f"lm_mesh {name} rank {rank}: parameters finite and moved")
        require(runs[0]["losses"] == runs[1]["losses"] and
                all(runs[0]["faults"][f]["loss"] == runs[1]["faults"][f]["loss"]
                    for f in readings),
                f"lm_mesh {name}: the ranks' losses are the global mean, "
                f"bitwise the same: {[r['losses'] for r in runs]}")
        require(err < LM_MESH_LOSS_BOUND,
                f"lm_mesh {name}: first-step loss {runs[0]['losses'][0]} "
                f"against the single-rank step's {ref_loss} ({err} relative)")
        require(readings["sound"]["logits_rel_err"] < LM_MESH_LOGITS_BOUND,
                f"lm_mesh {name}: the first step's logits differ from the "
                f"single-rank forward's by {readings['sound']} relative")
        require(len(faults) == (2 if "sp" in sizes else 1),
                f"lm_mesh {name}: faults planted: {sorted(faults)}")
        for fault, r in faults.items():
            require(r["loss_rel_err"] > LM_MESH_LOSS_BOUND and
                    r["logits_rel_err"] > LM_MESH_LOGITS_BOUND,
                    f"lm_mesh {name}: the planted fault {fault} moves the "
                    f"first step's loss and logits by {r} relative, within "
                    f"a bound ({LM_MESH_LOSS_BOUND}, {LM_MESH_LOGITS_BOUND})")
        require(all(runs[0]["digests"][k] == runs[1]["digests"][k]
                    for k in replicated),
                f"lm_mesh {name}: replicated leaves bitwise equal across "
                "the ranks")
        for kernel in (*FLASH_NAMES, "fused_adam"):
            launches.setdefault(kernel, {})[name] = [
                r["launches"][kernel] for r in runs]
    for name in ring["gated"]:
        e = ring["errors"][name]
        require(e["share_of_bound_max"] <= 1.0,
                f"ring flash attention at sp = 2: a row of {name} differs "
                f"from its reference by {e['share_of_bound_max']} of its "
                "bound")
    return launches


def moe_tokens(vocab):
    """The global batch of moe_mesh (8 x 2048 tokens and their next
    tokens), the same on every rank and in the parent: Zipf frequencies
    (``MOE_ZIPF``) over a fixed random order of the vocabulary."""
    rng = np.random.default_rng(SEED + 9)
    freq = 1.0 / np.arange(1, vocab + 1) ** MOE_ZIPF
    ids = rng.permutation(vocab)[rng.choice(
        vocab, size=(LM_BATCH, LM_SEQ + 1), p=freq / freq.sum())]
    return (ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))


def port_kernels():
    """Every kernel wrapper of the port, by name."""
    from mxnet_tpu_torch.kernels import comm_kernels as ck
    from mxnet_tpu_torch.kernels import flash_attention as tfa
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.kernels import int8_matmul as k8

    return {k.__name__: k for k in (k8.int8_matmul, kfa.fused_adam,
                                    *(getattr(tfa, n) for n in FLASH_NAMES),
                                    *ck.KERNELS)}


def moe_yard_block(torch, whole, s, x):
    """Stage ``s`` of the yardstick on one microbatch ``x`` ``[mb, seq,
    d]``, f32: pre-LN causal attention, then the top-1 MoE FFN with every
    expert local, each expert taking its first ``capacity`` tokens in order
    (index lists, not one-hot products). Returns the output, the Switch aux
    and each token's expert and slot (-1: dropped)."""
    F = torch.nn.functional
    cfg = MOE_CONFIG
    mb, seq, d = x.shape
    h, n_exp = cfg["n_heads"], cfg["n_experts"]
    y = F.layer_norm(x, (d,), whole["ln1_scale"][s], whole["ln1_bias"][s],
                     eps=1e-5)
    q, k, v = (y @ whole["wqkv"][s]).reshape(mb, seq, 3, h, d // h).permute(
        2, 0, 3, 1, 4)
    scores = q @ k.transpose(-1, -2) / float(np.sqrt(np.float32(d // h)))
    causal = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1) @ v
    x = x + att.transpose(1, 2).reshape(mb, seq, d) @ whole["wo"][s]
    y = F.layer_norm(x, (d,), whole["ln2_scale"][s], whole["ln2_bias"][s],
                     eps=1e-5).reshape(mb * seq, d)
    probs = torch.softmax(y @ whole["gate"][s], -1)
    gate, expert = probs.max(-1)
    capacity = max(1, int(cfg["capacity_factor"] * y.shape[0] / n_exp))
    out = torch.zeros_like(y)
    slot = torch.full((y.shape[0],), -1, dtype=torch.long, device=x.device)
    for e in range(n_exp):
        mine = torch.nonzero(expert == e)[:capacity, 0]
        slot[mine] = torch.arange(len(mine), device=x.device)
        hid = F.gelu(y[mine] @ whole["w1"][s, e], approximate="tanh")
        out[mine] = (hid @ whole["w2"][s, e]) * gate[mine, None]
    frac = torch.bincount(expert, minlength=n_exp).float() / y.shape[0]
    aux = n_exp * torch.sum(frac * probs.mean(0))
    return x + out.reshape(mb, seq, d), aux, (expert, slot)


def moe_yardstick(torch, whole, tokens, targets, backward=False):
    """The MoE LM's loss, computed in one process on the card from the
    global parameters ``whole`` and batch: each (dp, ep) shard's
    microbatches through stage 0, then stage 1 (:func:`moe_yard_block`:
    the shard's tokens, all experts local, so the same capacity and
    routing as on the mesh), then the masked NLL and aux as the model
    defines them. With ``backward``, each shard's share of the loss is
    differentiated by autograd as it is formed, so the leaves of ``whole``
    hold the step's gradient. Returns the loss and the routing by (stage,
    shard, microbatch)."""
    F = torch.nn.functional
    cfg = MOE_CONFIG
    n_micro, d = cfg["n_micro"], cfg["d_model"]
    shards = MOE_MESH["ep"]
    rows = LM_BATCH // shards
    loss = 0.0
    routes = {}
    with torch.set_grad_enabled(backward):
        for e in range(shards):
            tok = torch.from_numpy(tokens[e * rows:(e + 1) * rows]).cuda()
            tgt = torch.from_numpy(targets[e * rows:(e + 1) * rows]).cuda()
            x = whole["embed"][tok.long()] * float(np.sqrt(d)) \
                + whole["pos_embed"][:LM_SEQ]
            outs, aux = [], 0.0
            for m, xm in enumerate(x.chunk(n_micro)):
                for s in range(MOE_MESH["pp"]):
                    xm, a, route = moe_yard_block(torch, whole, s, xm)
                    aux = aux + a
                    routes[(s, e, m)] = tuple(r.cpu().numpy() for r in route)
                outs.append(xm)
            y = F.layer_norm(torch.cat(outs), (d,), whole["final_norm_scale"],
                             whole["final_norm_bias"], eps=1e-5)
            nll = F.cross_entropy((y @ whole["lm_head"]).reshape(
                -1, cfg["vocab_size"]), tgt.long().reshape(-1),
                reduction="sum")
            share = (nll / (LM_BATCH * LM_SEQ)
                     + cfg["aux_loss_coef"] * aux / n_micro / shards)
            if backward:
                share.backward()
            loss += float(share.detach())
            del x, outs, y, nll, share
    return loss, routes


def moe_yardstick_steps(torch, model, tokens, targets):
    """The yardstick's losses before and after one step of SGD with
    momentum from zero momentum (``w -= lr g``), and the routing of the
    first: what the mesh's first two steps must return."""
    whole = {k: v.requires_grad_(True) for k, v in
             model.init_params(SEED, MOE_MESH["pp"]).items()}
    first, routes = moe_yardstick(torch, whole, tokens, targets,
                                  backward=True)
    with torch.no_grad():
        for w in whole.values():
            w -= MOE_LR * w.grad   # the momentum from zero is the gradient
            w.grad = None
    second, _ = moe_yardstick(torch, whole, tokens, targets)
    del whole
    torch.cuda.empty_cache()
    return first, second, routes


def moe_mesh_faults(torch, model, mesh, params, tok, tgt):
    """Readings of the loss with one fault planted at a time, each an error
    the port could make and still run, and the same reading sound. The code
    is not changed: the parameters or the configuration are, or a function
    as a module or the model sees it is swapped for the one reading.

    ``forward``: the loss of the first step's parameters ``params`` (this
    rank's blocks): the stages in reverse order (the parameters of the other
    stage), the inverse all-to-all without its transpose (the experts'
    outputs go back to the wrong sources), the capacity counted over the
    global tokens of a microbatch (every shard's, not this rank's: the
    capacity factor times the shards), and the aux left unmasked at the
    bubble ticks. The sound reading also records each real tick's routing
    (expert and slot of every token), keyed by microbatch.

    ``backward``: the loss after one train step from ``params`` and zero
    momentum, the step taken with the fault: the gradient of the dispatch
    all-to-all with its expert rows in the wrong order (local expert major,
    where the global expert index is owner major), and the stage leaves'
    gradients summed over dp only, not over dp x ep."""
    from mxnet_tpu_torch.models import moe_transformer
    from mxnet_tpu_torch.parallel import expert, pipeline

    stage, n_micro = mesh.coords["pp"], MOE_CONFIG["n_micro"]
    ep = mesh.shape["ep"]
    shards = mesh.shape["dp"] * ep
    routes, calls = {}, [0]
    ffn, exchange = moe_transformer.moe_ffn, expert.all_to_all

    def recording(x, gate_w, w1, w2, group=None, capacity_factor=2.0,
                  return_aux=False):
        tick = calls[0]
        calls[0] += 1
        if pipeline.holds_data(tick, stage, n_micro):
            capacity = expert.expert_capacity(capacity_factor, x.shape[0],
                                              gate_w.shape[1])
            _, _, onehot, dispatch = expert.route(x.float(), gate_w,
                                                  capacity)
            slot = torch.where(dispatch.sum((1, 2)) > 0,
                               dispatch.sum(1).argmax(-1), -1)
            routes[tick - stage] = (onehot.argmax(-1).cpu().numpy(),
                                    slot.cpu().numpy())
        return ffn(x, gate_w, w1, w2, group, capacity_factor, return_aux)

    def source_major_to_expert_major(t):
        # rows s * e_local + j (rank s, its local expert j) as j * ep + s
        return t.reshape(ep, t.shape[0] // ep, *t.shape[1:]).transpose(
            0, 1).reshape(t.shape)

    def untransposed(t, axis, split_axis, concat_axis):
        # the inverse route (concat on 0) sent as the experts' outputs lie,
        # without moving each source's slots to the front
        if concat_axis == 0:
            t = source_major_to_expert_major(t)
        return exchange(t, axis, split_axis, concat_axis)

    class ExpertMajorGradient(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, axis, split_axis, concat_axis):
            ctx.args = axis, concat_axis, split_axis
            return exchange(t, axis, split_axis, concat_axis)

        @staticmethod
        def backward(ctx, g):
            return (source_major_to_expert_major(exchange(g, *ctx.args)),
                    None, None, None)

    def dispatch_grad_expert_major(t, axis, split_axis, concat_axis):
        if concat_axis == 1:   # the dispatch; the inverse route is sound
            return ExpertMajorGradient.apply(t, axis, split_axis, concat_axis)
        return exchange(t, axis, split_axis, concat_axis)

    def read(p, m=model):
        with torch.no_grad():
            return float(m.loss(mesh, p, tok, tgt))

    def swapped(target, name, fn, reading):
        before = getattr(target, name)
        setattr(target, name, fn)
        try:
            return reading()
        finally:
            if target is model:
                delattr(model, name)
            else:
                setattr(target, name, before)

    def after_step():
        p = {k: v.clone() for k, v in params.items()}
        moms = {k: torch.zeros_like(v) for k, v in p.items()}
        p, _, _ = model.make_train_step(mesh, lr=MOE_LR,
                                        momentum=MOE_MOMENTUM)(p, moms, tok,
                                                               tgt)
        return read(p)

    forward = {"sound": swapped(moe_transformer, "moe_ffn", recording,
                                lambda: read(params))}
    whole = model.init_params(SEED, mesh.shape["pp"])
    shardings = model.param_shardings(mesh)
    forward["stages_reversed"] = read({
        k: shardings[k].shard(v.flip(0) if k in moe_transformer.STAGE_KEYS
                              else v) for k, v in whole.items()})
    del whole
    forward["inverse_route_untransposed"] = swapped(
        expert, "all_to_all", untransposed, lambda: read(params))
    forward["capacity_over_global_tokens"] = read(params, type(model)(dict(
        model.cfg, capacity_factor=model.cfg["capacity_factor"] * shards)))
    forward["aux_unmasked"] = swapped(pipeline, "holds_data",
                                      lambda tick, stage, n_micro: True,
                                      lambda: read(params))
    sums = model.grad_axes(mesh)
    backward = {
        "sound": after_step(),
        "dispatch_gradient_expert_major": swapped(
            expert, "all_to_all", dispatch_grad_expert_major, after_step),
        "stage_gradients_not_summed_over_ep": swapped(
            model, "grad_axes", lambda m: {
                k: m.axis("dp") if k in moe_transformer.STAGE_KEYS else a
                for k, a in sums.items()}, after_step)}
    return {"forward": forward, "backward": backward}, routes


def moe_mesh_rank(torch, rank, world):
    """One rank's run of the MoE pipeline LM on dp 1 x pp 2 x ep 2:
    MOE_STEPS steps of ``make_train_step(mesh, lr, momentum)`` on its block
    of the global batch, every kernel's launches counted around them; the
    first step's loss with faults planted (:func:`moe_mesh_faults`); then
    one more step split on the card's clock. Returns numpy and Python values
    only."""
    import hashlib

    import torch.distributed as dist

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import MoEPipelineLM, moe_pipeline_config
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.mesh import P, Sharding

    mesh = make_mesh(**MOE_MESH, devices=mt.gpu(0))
    model = MoEPipelineLM(moe_pipeline_config(**MOE_CONFIG))
    params, moms = model.init_sharded(mesh, seed=SEED)
    params0 = {k: v.clone() for k, v in params.items()}
    batch = Sharding(mesh, P(("dp", "ep"), None))
    tok, tgt = (batch.shard(t)
                for t in moe_tokens(MOE_CONFIG["vocab_size"]))
    step = model.make_train_step(mesh, lr=MOE_LR, momentum=MOE_MOMENTUM)
    kernels = port_kernels()
    torch.cuda.synchronize()
    dist.barrier()
    # the main path: every count is read around the steps
    for fn in kernels.values():
        fn.launches = 0
    losses, stamps = [], [time.perf_counter()]
    for _ in range(MOE_STEPS):
        params, moms, loss = step(params, moms, tok, tgt)
        losses.append(float(loss))   # syncs the host with the step
        stamps.append(time.perf_counter())
    out = {
        "coords": dict(mesh.coords),
        "launches": {n: fn.launches for n, fn in kernels.items()},
        "losses": losses,
        "step_ms": [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])],
        "local_tokens": list(tok.shape),
        "finite": all(bool(torch.isfinite(v).all()) for v in params.values()),
        "moved": all(not torch.equal(v, params0[k])
                     for k, v in params.items()),
        "digests": {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
                    for k, v in params.items()},
        # which block of each leaf this rank holds: its coordinates on the
        # axes the leaf is split over
        "blocks": {k: tuple(mesh.coords[a] for a in sh.spec if a is not None)
                   for k, sh in model.param_shardings(mesh).items()},
        "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    out["faults"], out["routes"] = moe_mesh_faults(torch, model, mesh,
                                                   params0, tok, tgt)
    del params0
    # one more step, split on the card's clock by the step's own marks
    out["split"] = split_step(torch, lambda mark: step(params, moms, tok,
                                                       tgt, mark=mark))
    torch.cuda.empty_cache()
    return out


def phase_moe_mesh(torch):
    """The MoE pipeline LM trained on four ranks sharing the card, with its
    checks against the yardstick; returns each kernel's launches per rank
    (none: the path runs no hand-written kernel)."""
    from mxnet_tpu_torch.models import MoEPipelineLM, moe_pipeline_config

    model = MoEPipelineLM(moe_pipeline_config(**MOE_CONFIG))
    tokens, targets = moe_tokens(MOE_CONFIG["vocab_size"])
    *ref_losses, ref_routes = moe_yardstick_steps(torch, model, tokens,
                                                  targets)
    ranks = run_ranks(torch, moe_mesh_rank, MOE_MESH_WORLD,
                      MOE_MESH_TIMEOUT_S, "moe_mesh")

    r0 = ranks[0]
    # the step's own first and second losses against the yardstick's, and
    # each planted fault's reading against the same
    readings = {}
    for kind, ref, got in zip(("forward", "backward"), ref_losses,
                              r0["losses"]):
        readings[kind] = {"step": abs(got - ref) / ref, **{
            f: abs(v - ref) / ref for f, v in r0["faults"][kind].items()}}
    agree = total = dropped = 0
    for run in ranks:
        stage = run["coords"]["pp"]
        shard = run["coords"]["dp"] * MOE_MESH["ep"] + run["coords"]["ep"]
        for micro, (experts, slots) in run["routes"].items():
            want_e, want_s = ref_routes[(stage, shard, micro)]
            agree += int(((experts == want_e) & (slots == want_s)).sum())
            total += len(want_e)
            dropped += int((want_s < 0).sum())
    mismatched = []
    for k in r0["blocks"]:
        held = {}
        for run in ranks:
            held.setdefault(run["blocks"][k], set()).add(run["digests"][k])
        mismatched += [k for v in held.values() if len(v) > 1]
    median_ms = statistics.median(r0["step_ms"])
    emit({"phase": "moe_mesh", "mesh_shape": {"dp": 1, **MOE_MESH},
          "world": MOE_MESH_WORLD, "config": MOE_CONFIG,
          "transport": "gloo through pinned host buffers, four ranks on "
                       "one card",
          "global_batch": [LM_BATCH, LM_SEQ],
          "local_tokens": r0["local_tokens"], "token_zipf": MOE_ZIPF,
          "steps": MOE_STEPS, "optimizer": "sgd_momentum",
          "learning_rate": MOE_LR, "momentum": MOE_MOMENTUM,
          "yardstick_losses": ref_losses,
          "first_loss_rel_err": readings["forward"]["step"],
          "second_loss_rel_err": readings["backward"]["step"],
          "bounds": {"forward": MOE_LOSS_BOUND, "backward": MOE_STEP_BOUND},
          "step_sound_and_planted_faults": readings,
          "routing_agreement": agree / total, "routed_tokens": total,
          "dropped_tokens": dropped,
          "losses": r0["losses"],
          "replicated_leaves_mismatched": mismatched,
          "step_ms": r0["step_ms"], "step_ms_median": median_ms,
          "global_tokens_per_s": LM_BATCH * LM_SEQ * 1e3 / median_ms,
          "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
          "split_by_rank": [dict(r["split"], coords=r["coords"])
                            for r in ranks]})
    for rank, run in enumerate(ranks):
        require(np.isfinite(run["losses"]).all(),
                f"moe_mesh rank {rank}: finite losses {run['losses']}")
        require(run["finite"] and run["moved"],
                f"moe_mesh rank {rank}: parameters finite and moved")
        require(run["losses"] == r0["losses"] and run["faults"] == r0[
                    "faults"],
                f"moe_mesh rank {rank}: the loss is the global one, bitwise "
                "the same on every rank")
        require(not any(run["launches"].values()),
                f"moe_mesh rank {rank}: a hand-written kernel ran on a path "
                f"that has none: {run['launches']}")
    for kind, bound in (("forward", MOE_LOSS_BOUND),
                        ("backward", MOE_STEP_BOUND)):
        got = readings[kind]
        step = 0 if kind == "forward" else 1
        require(got["step"] < bound,
                f"moe_mesh: step {step + 1}'s loss {r0['losses'][step]} "
                f"against the yardstick's {ref_losses[step]} ({got['step']} "
                f"relative, bound {bound})")
        require(r0["faults"][kind]["sound"] == r0["losses"][step],
                f"moe_mesh: step {step + 1}'s loss {r0['losses'][step]} is "
                f"the one read apart, {r0['faults'][kind]['sound']}")
        faults = {f: r for f, r in got.items() if f not in ("step", "sound")}
        require(len(faults) == (4 if kind == "forward" else 2),
                f"moe_mesh: {kind} faults planted: {sorted(faults)}")
        for fault, r in faults.items():
            require(r > bound,
                    f"moe_mesh: the planted fault {fault} moves step "
                    f"{step + 1}'s loss by {r} relative, within the bound "
                    f"{bound}")
    require(not mismatched, f"moe_mesh: replicated blocks bitwise equal "
            f"across the ranks: {mismatched} differ")
    return {n: [r["launches"][n] for r in ranks] for n in r0["launches"]}


def first_forward(torch, mt, net, args, aux, batch_x, batch_y, dtype):
    """One training-mode forward of the seeded weights on the card, in
    ``dtype`` (auxiliary states and labels f32), no update: the loss per
    image and the centred log-probabilities."""
    from mxnet_tpu_torch.executor import _build_graph_fn
    from mxnet_tpu_torch.ops import OPS

    dev = mt.gpu(0).torch_device
    values = {k: torch.from_numpy(v).to(dev).to(dtype)
              for k, v in args.items()}
    values["data"] = torch.from_numpy(batch_x).to(dev).to(dtype)
    values["softmax_label"] = torch.from_numpy(batch_y).to(dev)
    with torch.no_grad():
        outs, _ = _build_graph_fn(net, is_train=True)(
            values, {k: torch.from_numpy(v).to(dev) for k, v in aux.items()})
    p = outs[0].float()
    loss = float(OPS.create("SoftmaxOutput").loss_value(
        p, values["softmax_label"])) / len(batch_x)
    return loss, centered_logits(p.cpu().numpy())


def bf16_softmax_fault(torch):
    """A planted fault the reference's rounding points forbid
    (mxnet_tpu/ops/loss.py:24): the loss head's softmax taken in bf16, its
    sum carried in bf16 across the classes."""
    def softmax(x, axis):
        e = torch.exp(x - x.amax(dim=axis, keepdim=True))
        total = torch.zeros_like(e.select(axis, 0))
        for i in range(e.shape[axis]):
            total = total + e.select(axis, i)
        return e / total.unsqueeze(axis)

    return softmax


def bf16_stats_fault(torch, nn):
    """BatchNorm's batch statistics taken in bf16 (mxnet_tpu/ops/nn.py:
    425-443 takes them in f32)."""
    def stats(x, eps, ch, group=None):
        del group  # one device: no rank's rows to add
        axes = nn._bn_reduce_axes(x.ndim, ch)
        n = x.numel() // x.shape[ch]
        mean = torch.sum(x, dim=axes) / n
        var = torch.clamp_min(torch.sum(x * x, dim=axes) / n - mean * mean,
                              0.0)
        return mean.float(), var.float(), torch.rsqrt(var + eps).float()

    return stats


def update_gap(torch, start, a, b):
    """|a - b| / |a - start| over all leaves (relative Frobenius of the
    difference of two runs' updates from the same start)."""
    num = den = 0.0
    for k, v0 in start.items():
        pa, pb = a[k].double(), b[k].double()
        num += float(((pa - pb) ** 2).sum())
        den += float(((pa - torch.from_numpy(v0).double()) ** 2).sum())
    return (num / den) ** 0.5


def set_remat(pattern):
    import os

    if pattern is None:
        os.environ.pop("MXNET_TPU_REMAT", None)
    else:
        os.environ["MXNET_TPU_REMAT"] = pattern


def phase_train_bf16(torch, mt, f32_row):
    """ResNet-50 with bf16 compute_dtype on the card: the first forward
    against f32, planted faults, 8 fit steps without and with remat (the
    remat fit captured and eager), and phase train's f32 fit under the
    "default" precision (TF32)."""
    from mxnet_tpu_torch.ops import loss as tloss
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.utils import compile as tcm

    net, args, aux, batch_x, batch_y = resnet50_case()
    bf16 = torch.bfloat16
    mt.set_matmul_precision("highest")
    set_remat(None)
    l32, lp32 = first_forward(torch, mt, net, args, aux, batch_x, batch_y,
                              torch.float32)

    def against_f32():
        l16, lp16 = first_forward(torch, mt, net, args, aux, batch_x, batch_y,
                                  bf16)
        return {"loss_rel_err": abs(l16 - l32) / l32,
                "logits_rel_err": rel_fro(lp16, lp32)}

    def above(reading):
        return reading["loss_rel_err"] > BF16_LOSS_BOUND or \
            reading["logits_rel_err"] > BF16_LOGITS_BOUND

    healthy = against_f32()
    require(not above(healthy),
            f"bf16 first forward against f32: {healthy} (bounds "
            f"{BF16_LOSS_BOUND}, {BF16_LOGITS_BOUND})")
    faults = {}
    for name, module, attr, fault in (
            ("softmax_bf16", tloss, "_softmax", bf16_softmax_fault(torch)),
            ("bn_stats_bf16", tnn, "_bn_stats", bf16_stats_fault(torch, tnn))):
        original = getattr(module, attr)
        setattr(module, attr, fault)
        try:
            faults[name] = against_f32()
        finally:
            setattr(module, attr, original)
    require(above(faults["softmax_bf16"]),
            f"planted fault (softmax in bf16) reads {faults['softmax_bf16']}, "
            "inside the bounds")

    runs, params = {}, {}
    for tag, pattern, precision, dtype, captured in (
            ("bf16", None, "highest", bf16, True),
            ("bf16_again", None, "highest", bf16, True),
            ("bf16_remat", REMAT_PATTERN, "highest", bf16, True),
            ("bf16_remat_eager", REMAT_PATTERN, "highest", bf16, False),
            ("f32_default", None, "default", None, True)):
        set_remat(pattern)
        set_graphs(captured)
        mt.set_matmul_precision(precision)
        tcm.reset_compile_stats()
        model, runs[tag] = fit_one_batch(
            torch, mt, net, args, aux, batch_x, batch_y,
            compute_dtype=dtype)
        runs[tag]["graphs"] = graph_stats(tcm)
        require_trained(runs[tag], TRAIN_STEPS, f"train_bf16 {tag}")
        # the host copies after the fit (not the split's further steps)
        params[tag] = model.arg_params
        del model  # each fit's peak counts its own tensors only
        gc.collect()
        for k, v in params[tag].items():
            require(torch.isfinite(v).all(), f"{tag}: parameter {k} finite")
            require(v.dtype == torch.float32, f"{tag}: {k} stays f32")
    set_remat(None)
    set_graphs(True)
    mt.set_matmul_precision("highest")
    # C.1.6: the remat fit replays captured steps, with no eager reason
    remat_graphs = runs["bf16_remat"]["graphs"]
    require(remat_graphs["captures"] == 1
            and remat_graphs["replays"] == TRAIN_STEPS - 1
            and not remat_graphs["eager"],
            f"train_bf16: the remat fit is captured: {remat_graphs}")
    fit_loss_err = abs(runs["bf16"]["loss_first"] - f32_row["loss_first"]) \
        / f32_row["loss_first"]
    require(fit_loss_err < BF16_LOSS_BOUND,
            f"bf16 fit's first loss {runs['bf16']['loss_first']} against "
            f"f32's {f32_row['loss_first']}: {fit_loss_err}")
    require(runs["bf16_remat"]["loss_first"] == runs["bf16"]["loss_first"],
            "remat's first-step loss is bitwise the plain one's: "
            f"{runs['bf16_remat']['loss_first']} vs {runs['bf16']['loss_first']}")
    gaps = {"remat_vs_plain": update_gap(torch, args, params["bf16_remat"],
                                         params["bf16"]),
            "plain_vs_plain": update_gap(torch, args, params["bf16_again"],
                                         params["bf16"]),
            "remat_captured_vs_eager": update_gap(
                torch, args, params["bf16_remat"],
                params["bf16_remat_eager"])}
    require(gaps["remat_vs_plain"] < REMAT_UPDATE_BOUND,
            f"remat's update against the plain one's: {gaps}")
    require(gaps["remat_captured_vs_eager"] < REMAT_UPDATE_BOUND,
            f"the captured remat fit's update against the eager one's: {gaps}")
    require(runs["bf16_remat_eager"]["loss_first"]
            == runs["bf16_remat"]["loss_first"],
            "the captured remat fit's first loss is bitwise the eager one's")
    require(runs["bf16_remat"]["peak_memory_gb"]
            < runs["bf16"]["peak_memory_gb"],
            "remat keeps fewer activations: peak "
            f"{runs['bf16_remat']['peak_memory_gb']} GB against "
            f"{runs['bf16']['peak_memory_gb']} GB")
    row = {"phase": "train_bf16", "model": "resnet50", "batch": BATCH,
           "steps": TRAIN_STEPS, "optimizer": "adam", "fused": True,
           "remat_pattern": REMAT_PATTERN,
           "first_forward_against_f32": healthy, "planted_faults": faults,
           "bounds": {"loss": BF16_LOSS_BOUND, "logits": BF16_LOGITS_BOUND,
                      "remat_update": REMAT_UPDATE_BOUND},
           "fit_first_loss_rel_err": fit_loss_err, "update_gaps": gaps,
           "f32_highest": {k: f32_row[k] for k in (
               "step_ms_median", "images_per_s", "split", "peak_memory_gb",
               "loss_first", "loss_last")},
           **{tag: {k: v for k, v in r.items() if k != "losses"}
              for tag, r in runs.items()}}
    emit(row)
    return {tag: r["launches"] for tag, r in runs.items()}


def phase_serve_bf16(torch, mt, k8):
    """Phase slice's int8 request under both precisions, and the bf16
    FeedForward.predict of the same weights against the f32 logits."""
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.models import resnet50

    net = resnet50(num_classes=1000)
    data_shape = (BATCH,) + IMAGE
    args, aux = random_params(net, SEED, data=data_shape)
    image = np.random.default_rng(SEED + 1).standard_normal(data_shape,
                                                            np.float32)
    gpu = mt.gpu(0)

    def serve(fn):
        outs, lat = [], []
        fn()  # warm-up: cuDNN's algorithm choice at this precision
        torch.cuda.synchronize()
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            outs.append(fn())
            lat.append((time.perf_counter() - t0) * 1e3)
        return outs, lat

    p8 = mt.Predictor(net, args, aux, ctx=gpu, quantize="int8")
    row, int8_out = {"phase": "serve_bf16", "model": "resnet50",
                     "batch": BATCH, "requests": REQUESTS}, {}
    for precision in ("highest", "default"):
        mt.set_matmul_precision(precision)
        k8.int8_matmul.launches = 0
        outs, lat = serve(lambda: p8.forward(data=image).get_output(0))
        launches = k8.int8_matmul.launches
        require(launches == REQUESTS + 1,
                f"int8_matmul launched {launches} times in {REQUESTS + 1} "
                f"int8 requests under {precision}")
        require(all(np.isfinite(o).all() and o.shape == (BATCH, 1000)
                    for o in outs), f"int8 outputs finite ({precision})")
        int8_out[precision] = outs[0]
        med = statistics.median(lat)
        row[f"int8_{precision}"] = {
            "request_ms": lat, "request_ms_median": med,
            "images_per_s": BATCH * 1e3 / med, "int8_matmul_launches":
            launches}
    row["int8_default_vs_highest_logits_rel_err"] = rel_fro(
        centered_logits(int8_out["default"]),
        centered_logits(int8_out["highest"]))
    mt.set_matmul_precision("highest")
    ref = mt.Predictor(net, args, aux, ctx=gpu).forward(
        data=image).get_output(0)
    model = mt.FeedForward(net, ctx=gpu, arg_params=args, aux_params=aux,
                           compute_dtype=torch.bfloat16)
    outs, lat = serve(lambda: model.predict(image, batch_size=BATCH))
    err = rel_fro(centered_logits(outs[0]), centered_logits(ref))
    require(outs[0].dtype == np.float32 and np.isfinite(outs[0]).all(),
            "bf16 predict returns finite f32")
    require(err < BF16_LOGITS_BOUND,
            f"bf16 predict against the f32 logits: {err}")
    med = statistics.median(lat)
    row["bf16_predict"] = {"request_ms": lat, "request_ms_median": med,
                           "images_per_s": BATCH * 1e3 / med,
                           "logits_rel_err_vs_f32": err,
                           "bound": BF16_LOGITS_BOUND}
    emit(row)


def remat_grads(torch, mt, net, args, aux, batch_x, batch_y, pattern):
    """One bf16 training forward and backward of ``net`` with the card's
    generator at SEED: the f32 masters' gradients."""
    from mxnet_tpu_torch.executor import _build_graph_fn

    set_remat(pattern)
    dev = mt.gpu(0).torch_device
    params = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in args.items()}
    values = {k: v.to(torch.bfloat16) for k, v in params.items()}
    values["data"] = torch.from_numpy(batch_x).to(dev).to(torch.bfloat16)
    values["softmax_label"] = torch.from_numpy(batch_y).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    outs, _ = _build_graph_fn(net, is_train=True)(
        values, {k: torch.from_numpy(v).to(dev) for k, v in aux.items()}, gen)
    grads = torch.autograd.grad(outs[0].float().sum(), list(params.values()))
    set_remat(None)
    return {k: g.double() for k, g in zip(params, grads)}


def checkpointed_without_restore(torch):
    """A planted fault: remat whose recompute draws from the generator as
    it stands, not the forward's draws back from its tape."""
    def checkpointed(block_fn, ext_vals, aux_vals, rng, mask):
        return torch.utils.checkpoint.checkpoint(
            lambda *ext: block_fn(ext, aux_vals, rng, mask), *ext_vals,
            use_reentrant=False, preserve_rng_state=False)

    return checkpointed


def remat_dropout_memory(torch, mt):
    """The remat tape's memory on the card: one training forward and
    backward of the REMAT_MLP net, plain, under remat, under remat with
    Dropout's p at 0 (no draw, no tape) and under remat with a planted tape
    that keeps the f32 uniforms, as the first tape did. Reads the memory
    held from the forward to the backward and the peak over both, above
    what the parameters and the batch hold. The tape (remat's held memory
    less p 0's) must be Dropout's bool masks, one byte an element, what the
    plain step's autograd keeps for them, where the planted tape reads four;
    and remat's peak below the plain step's."""
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.executor import _build_graph_fn
    from mxnet_tpu_torch.ops import registry

    batch, hidden, layers = (REMAT_MLP[k] for k in ("batch", "hidden",
                                                     "layers"))
    s = mt.sym

    def mlp(p):
        net = s.Variable("data")
        for i in range(1, layers + 1):
            net = s.FullyConnected(data=net, name=f"fc{i}", num_hidden=hidden)
            net = s.Activation(data=net, name=f"relu{i}", act_type="relu")
            net = s.Dropout(data=net, name=f"drop{i}", p=p)
        return s.SoftmaxOutput(data=s.FullyConnected(
            data=net, name="head", num_hidden=1000), name="softmax")

    dev = mt.gpu(0).torch_device
    args, _ = random_params(mlp(0.5), SEED, data=(batch, hidden))
    params = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in args.items()}
    rng = np.random.default_rng(SEED + 12)
    x = torch.from_numpy(rng.standard_normal((batch, hidden),
                                             np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 1000, batch).astype(
        np.float32)).to(dev)

    def step(p, pattern):
        set_remat(pattern)
        try:
            fn = _build_graph_fn(mlp(p), is_train=True)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs, _ = fn({**params, "data": x, "softmax_label": y}, {}, gen)
            held = torch.cuda.memory_allocated() - base
            grads = torch.autograd.grad(outs[0].sum(), list(params.values()))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del outs, grads
        finally:
            set_remat(None)
        return {"held_mib": held / 2 ** 20, "peak_mib": peak / 2 ** 20}

    def raw_uniforms(self, shape, rng, device, derive):
        if self._replay_at is None:
            u = torch.rand(shape, generator=rng, device=device)
            self.kept.append(u)
            return derive(u)
        self._replay_at += 1
        return derive(self.kept[self._replay_at - 1])

    runs = {"plain": step(0.5, None),
            "remat": step(0.5, REMAT_MLP_PATTERN),
            "remat_p0": step(0.0, REMAT_MLP_PATTERN)}
    real = registry.DrawTape.draw
    registry.DrawTape.draw = raw_uniforms
    try:
        runs["remat_fault"] = step(0.5, REMAT_MLP_PATTERN)
    finally:
        registry.DrawTape.draw = real
    masks_mib = layers * batch * hidden / 2 ** 20
    tape = {k: runs[k]["held_mib"] - runs["remat_p0"]["held_mib"]
            for k in ("remat", "remat_fault")}
    out = {"net": REMAT_MLP, "pattern": REMAT_MLP_PATTERN, "runs": runs,
           "masks_mib": masks_mib, "tape_mib": tape["remat"],
           "planted_f32_tape_mib": tape["remat_fault"]}
    require(abs(tape["remat"] - masks_mib) <= 0.01 * masks_mib,
            f"zoo: the remat tape holds Dropout's bool masks: {out}")
    require(tape["remat_fault"] > 2 * masks_mib,
            f"zoo: a planted tape of f32 uniforms reads above the masks: {out}")
    require(runs["remat"]["peak_mib"] < runs["plain"]["peak_mib"],
            f"zoo: remat's peak below the plain step's with Dropout: {out}")
    return out


def phase_zoo(torch, mt):
    """Full-width AlexNet (LRN, Dropout) and Inception-BN, bf16, fused
    Adam, a few steps each; AlexNet again under remat, captured and eager,
    and captured with a planted recompute that draws other masks."""
    from mxnet_tpu_torch import executor as texecutor
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.models import alexnet, inception_bn
    from mxnet_tpu_torch.utils import compile as tcm

    mt.set_matmul_precision("highest")
    shape = (BATCH,) + IMAGE
    rng = np.random.default_rng(SEED + 7)
    batch_x = rng.standard_normal(shape, np.float32)
    batch_y = rng.integers(0, 1000, BATCH).astype(np.float32)
    row, launches = {"phase": "zoo", "batch": BATCH, "steps": ZOO_STEPS,
                     "compute_dtype": "bfloat16"}, {}
    nets = {"alexnet": alexnet(num_classes=1000),
            "inception_bn": inception_bn(num_classes=1000)}
    params = {}
    original = texecutor._checkpointed
    for tag, name, pattern, captured in (
            ("alexnet", "alexnet", None, True),
            ("inception_bn", "inception_bn", None, True),
            ("alexnet_remat", "alexnet", ALEXNET_REMAT, True),
            ("alexnet_remat_eager", "alexnet", ALEXNET_REMAT, False),
            ("alexnet_remat_fault", "alexnet", ALEXNET_REMAT, True)):
        net = nets[name]
        args, aux = random_params(net, SEED, data=shape)
        set_remat(pattern)
        set_graphs(captured)
        if tag.endswith("fault"):
            texecutor._checkpointed = checkpointed_without_restore(torch)
        mt.random.seed(SEED)
        tcm.reset_compile_stats()
        try:
            model, r = fit_one_batch(torch, mt, net, args, aux, batch_x,
                                     batch_y, steps=ZOO_STEPS,
                                     compute_dtype=torch.bfloat16)
        finally:
            texecutor._checkpointed = original
            set_remat(None)
            set_graphs(True)
        r["graphs"] = graph_stats(tcm)
        params[tag] = model.arg_params
        del model
        require_trained(r, ZOO_STEPS, f"zoo {tag}", halves=True)
        launches[tag] = r["launches"]
        row[tag] = {k: v for k, v in r.items() if k != "losses"}
        row[tag]["losses"] = r["losses"]
    require(row["alexnet_remat"]["loss_first"] == row["alexnet"]["loss_first"],
            "AlexNet's first-step loss under remat is bitwise the plain one's "
            "(the same Dropout masks in the forward)")
    # C.1.6: the remat fit captured, held to the eager remat fit; a
    # captured recompute that draws other masks reads above the bound
    remat_graphs = row["alexnet_remat"]["graphs"]
    require(remat_graphs["captures"] == 1
            and remat_graphs["replays"] == ZOO_STEPS - 1
            and not remat_graphs["eager"],
            f"zoo: AlexNet's remat fit is captured: {remat_graphs}")
    capture_gaps = {
        "remat_captured_vs_eager": update_gap(
            torch, args, params["alexnet_remat"],
            params["alexnet_remat_eager"]),
        "plain_captured_vs_remat_eager": update_gap(
            torch, args, params["alexnet"], params["alexnet_remat_eager"]),
        "fault_captured_vs_eager": update_gap(
            torch, args, params["alexnet_remat_fault"],
            params["alexnet_remat_eager"]),
        "bound": REMAT_UPDATE_BOUND}
    require(capture_gaps["remat_captured_vs_eager"] < REMAT_UPDATE_BOUND,
            f"zoo: AlexNet's captured remat update against the eager one's: "
            f"{capture_gaps}")
    require(capture_gaps["fault_captured_vs_eager"] > REMAT_UPDATE_BOUND,
            "zoo: a captured recompute with other masks reads inside the "
            f"bound: {capture_gaps}")
    row["alexnet_remat_capture_gaps"] = capture_gaps
    del params
    row["alexnet_remat_masks"] = graphs_dropout(torch, mt,
                                                remat=ALEXNET_REMAT)
    # the recompute's Dropout masks: one step's gradients with and without
    # remat, from the same generator state, leaf by leaf
    net = nets["alexnet"]
    args, aux = random_params(net, SEED, data=shape)
    plain = remat_grads(torch, mt, net, args, aux, batch_x, batch_y, None)
    again = remat_grads(torch, mt, net, args, aux, batch_x, batch_y, None)
    remat = remat_grads(torch, mt, net, args, aux, batch_x, batch_y,
                        ALEXNET_REMAT)
    texecutor._checkpointed = checkpointed_without_restore(torch)
    try:
        fault = remat_grads(torch, mt, net, args, aux, batch_x, batch_y,
                            ALEXNET_REMAT)
    finally:
        texecutor._checkpointed = original

    def worst(got):
        errs = {k: float((got[k] - plain[k]).norm()
                         / max(float(plain[k].norm()), 1e-30))
                for k in plain}
        k = max(errs, key=errs.get)
        return {"leaf": k, "rel_err": errs[k]}

    grads = {"remat_vs_plain": worst(remat), "plain_vs_plain": worst(again),
             "fault_vs_plain": worst(fault),
             "bound": ZOO_REMAT_GRAD_BOUND}
    require(grads["remat_vs_plain"]["rel_err"] < ZOO_REMAT_GRAD_BOUND,
            f"AlexNet's remat gradients against the plain ones: {grads}")
    require(grads["fault_vs_plain"]["rel_err"] > ZOO_REMAT_GRAD_BOUND,
            f"planted fault (recompute with other masks) inside the bound: "
            f"{grads}")
    row["alexnet_remat_grads"] = grads
    row["remat_pattern"] = ALEXNET_REMAT
    row["remat_dropout_memory"] = remat_dropout_memory(torch, mt)
    emit(row)
    return launches


def phase_ndarray(torch, mt):
    """The imperative NDArray on the card (SURVEY 3.2), against numpy on the
    same values, and the generator's state round trip."""
    gpu = mt.gpu(0)
    mt.random.seed(SEED)
    a = mt.nd.ones(ND_SHAPE, ctx=gpu)
    b = mt.random.uniform(-1.0, 1.0, ND_SHAPE, ctx=gpu)
    an, bn = a.asnumpy(), b.asnumpy()
    require(a.context == gpu and b.data.is_cuda, "arrays on the card")
    exact = {
        "add": (a + b, an + bn), "sub": (a - b, an - bn),
        "mul": (b * b, bn * bn), "div": (b / (a + 1.0), bn / (an + 1.0)),
        "scalar": (b * 2.5 + 1.0, bn * np.float32(2.5) + np.float32(1.0)),
        "rsub": (1.0 - b, np.float32(1.0) - bn), "neg": (-b, -bn),
        "max_fn": (mt.nd.maximum(a, b), np.maximum(an, bn)),
        "clip": (mt.nd.clip(b, -0.5, 0.5), np.clip(bn, -0.5, 0.5)),
        "argmax_channel": (mt.nd.argmax_channel(b),
                           bn.argmax(1).astype(np.float32)),
        "max": (mt.nd.max(b), bn.max().reshape(1)),
        "min": (mt.nd.min(b), bn.min().reshape(1)),
    }
    c = b.copy()
    c += a
    c *= 3.0
    c -= b
    c /= 2.0
    cn = ((bn + an) * np.float32(3.0) - bn) / np.float32(2.0)
    exact["inplace"] = (c, cn)
    d = b.copy()
    d[100:200] = 0.5
    dn = bn.copy()
    dn[100:200] = 0.5
    exact["setitem"] = (d, dn)
    exact["slice"] = (b[100:110, 7:9], bn[100:110, 7:9])
    half = (ND_SHAPE[0] // 2, ND_SHAPE[1] * 2)
    exact["reshape_T"] = (b.reshape(half).T, bn.reshape(half).T)
    for name, (got, want) in exact.items():
        require(got.context == gpu, f"ndarray {name} stays on the card")
        require(np.array_equal(got.asnumpy(), want),
                f"ndarray {name} differs from numpy")
    require(np.array_equal(b.asnumpy(), bn) and np.array_equal(a.asnumpy(), an),
            "operands unchanged by the writes to their copies")
    sums = {"sum": (mt.nd.sum(b), bn.astype(np.float64).sum()),
            "norm": (mt.nd.norm(b),
                     np.sqrt((bn.astype(np.float64) ** 2).sum())),
            "dot": (mt.nd.dot(b[:512], b[:, :512]),
                    bn[:512].astype(np.float64) @ bn[:, :512])}
    sum_errs = {}
    for name, (got, want) in sums.items():
        g = got.asnumpy().astype(np.float64).reshape(np.shape(want))
        sum_errs[name] = float(np.linalg.norm(g - want)
                               / max(np.linalg.norm(want), 1e-30))
        # f32 sums of 16.8 M (sum, norm) or 4,096 (dot) terms of either sign
        require(sum_errs[name] < (1e-4 if name == "sum" else 1e-5),
                f"ndarray {name} against f64: {sum_errs[name]}")
    # placement: the card, host memory, pinned host memory and back
    on_cpu = b.copyto(mt.cpu())
    pinned = b.copyto(mt.cpu_pinned())
    back = pinned.copyto(gpu)
    require(on_cpu.context == mt.cpu() and not on_cpu.data.is_cuda,
            "copyto(cpu()) lands in host memory")
    require(pinned.data.is_pinned(), "copyto(cpu_pinned()) is pinned")
    require(back.data.is_cuda and torch.equal(back.data, b.data)
            and np.array_equal(on_cpu.asnumpy(), bn),
            "copies across cpu, cpu_pinned and gpu keep the values")
    stream = torch.cuda.current_stream()
    big = b
    for _ in range(20):
        big = big * 1.0001 + 0.5
    big.wait_to_read()
    require(stream.query(), "wait_to_read returns once the stream is done")
    for _ in range(20):
        big = big * 1.0001
    mt.nd.waitall()
    require(stream.query(), "waitall returns once the card is idle")
    # the generator's state round trip, on the card
    mt.random.seed(SEED + 11)
    state = mt.random.get_state()
    first = (mt.random.uniform(0, 1, ND_SHAPE, ctx=gpu),
             mt.random.normal(0, 1, ND_SHAPE, ctx=gpu))
    mt.random.uniform(0, 1, (7,), ctx=gpu)
    mt.random.set_state(state)
    second = (mt.random.uniform(0, 1, ND_SHAPE, ctx=gpu),
              mt.random.normal(0, 1, ND_SHAPE, ctx=gpu))
    require(all(torch.equal(x.data, y.data) for x, y in zip(first, second)),
            "set_state repeats the card's uniform and normal draws bitwise")
    times = {"add_ms": time_ms(torch, lambda: a + b),
             "iadd_ms": time_ms(torch, lambda: c.__iadd__(a)),
             "sum_ms": time_ms(torch, lambda: mt.nd.sum(b)),
             "uniform_ms": time_ms(torch, lambda: mt.random.uniform(
                 0, 1, ND_SHAPE, ctx=gpu))}
    t0 = time.perf_counter()
    for _ in range(5):
        b.copyto(mt.cpu_pinned()).wait_to_read()
    times["copyto_pinned_ms_host"] = (time.perf_counter() - t0) * 200
    emit({"phase": "ndarray", "shape": list(ND_SHAPE), "exact": sorted(exact),
          "f64_rel_errs": sum_errs, "set_state_bitwise": True, **times})


def phase_monitor(torch, mt):
    """A Monitor on a bf16 ResNet-50 executor for two training steps."""
    import re

    net, args, aux, batch_x, batch_y = resnet50_case()
    dev = mt.gpu(0).torch_device
    values = {k: torch.from_numpy(v).to(dev).to(torch.bfloat16)
              for k, v in args.items()}
    values["data"] = torch.from_numpy(batch_x).to(dev).to(torch.bfloat16)
    values["softmax_label"] = torch.from_numpy(batch_y).to(dev)
    ex = net.bind(mt.gpu(0), values,
                  args_grad={k: torch.zeros_like(values[k]) for k in args},
                  grad_req={k: "write" if k in args else "null"
                            for k in net.list_arguments()},
                  aux_states=aux)
    mon = mt.Monitor(interval=1, pattern=MONITOR_PATTERN)
    mon.install(ex)
    names = [n for n in net.get_internals().list_outputs()
             if re.match(MONITOR_PATTERN, n)]
    steps, toc_ms = [], []
    for _ in range(MONITOR_STEPS):
        mon.tic()
        ex.forward(is_train=True)
        ex.backward()
        t0 = time.perf_counter()
        steps.append(mon.toc())
        toc_ms.append((time.perf_counter() - t0) * 1e3)
    for rows in steps:
        require([r[1] for r in rows] == names and len(names) == 16,
                f"one statistic per matched internal: {[r[1] for r in rows]}")
        require(all(np.isfinite(float(r[2])) for r in rows),
                "finite statistics")
    emit({"phase": "monitor", "model": "resnet50", "compute_dtype": "bfloat16",
          "pattern": MONITOR_PATTERN, "matched": len(names),
          "steps": [[(r[0], r[1], float(r[2])) for r in rows[:3]]
                    for rows in steps], "toc_ms": toc_ms})


# -- slice 10: the data path --------------------------------------------------


def reset_launches():
    for k in port_kernels().values():
        k.launches = 0


def read_launches():
    return {n: k.launches for n, k in port_kernels().items()}


def io_image(rng, h, w):
    """A smooth gradient like the JAX package's io bench shard
    (bench.py:240-262), at ``h`` x ``w``."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    size = max(h, w)
    f = rng.uniform(0.5, 4.0, 3)
    ph = rng.uniform(0, np.pi, 3)
    return np.stack([127 + 120 * np.sin(2 * np.pi * f[c] * (yy + xx) / size
                                        + ph[c]) for c in range(3)],
                    axis=-1).astype(np.uint8)


def write_io_shard(mt, path):
    """``IO_RECORDS`` PNG records, sides drawn from ``IO_SIDES``, labels
    ``i % 1000``; the images are made and encoded on a thread pool."""
    import os

    rng = np.random.RandomState(SEED)
    specs = [(i, int(rng.randint(*IO_SIDES)), int(rng.randint(*IO_SIDES)),
              int(rng.randint(2 ** 31 - 1))) for i in range(IO_RECORDS)]

    def record(spec):
        i, h, w, seed = spec
        img = io_image(np.random.RandomState(seed), h, w)
        return mt.recordio.pack_img(mt.recordio.IRHeader(
            0, float(i % 1000), i, 0), img, img_fmt=".png")

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        payloads = list(pool.map(record, specs))
    with mt.recordio.MXRecordIO(path, "w") as w:
        for p in payloads:
            w.write(p)
    return sum(len(p) for p in payloads)


def io_iter(mt, path, **kw):
    return mt.io.ImageRecordIter(path_imgrec=path, **{**IO_ITER, **kw})


def phase_io_feed(torch, mt):
    """The RecordIO shard and the feed-only rate of ImageRecordIter."""
    import os

    os.makedirs(IO_DIR, exist_ok=True)
    # the decode threads: one a host core (the engine's documented knob)
    set_decode_threads(mt, os.cpu_count())
    path = os.path.join(IO_DIR, "shard.rec")
    t0 = time.perf_counter()
    shard_bytes = write_io_shard(mt, path)
    write_s = time.perf_counter() - t0
    reset_launches()
    it = io_iter(mt, path)
    t0 = time.perf_counter()
    shapes, n = set(), 0
    for b in it:
        shapes.add((tuple(b.data[0].shape), b.data[0].dtype))
        n += b.data[0].shape[0]
    feed_s = time.perf_counter() - t0
    launches = read_launches()
    require(n == IO_RECORDS and shapes == {(
                (IO_ITER["batch_size"],) + IO_ITER["data_shape"], torch.uint8)},
            f"io_feed: one epoch of {IO_RECORDS} uint8 images: {n}, {shapes}")
    again = [io_iter(mt, path), io_iter(mt, path)]
    firsts = [[(b.data[0].clone(), b.label[0].clone())
               for _, b in zip(range(4), a)] for a in again]
    require(all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
                for x, y in zip(*firsts)) and len(firsts[0]) == 4,
            "io_feed: 4 batches equal a second iterator's with the same seed")
    labels = torch.cat([lab for _, lab in firsts[0]])
    require(bool(((labels >= 0) & (labels < 1000)).all()),
            "io_feed: labels in range")
    emit({"phase": "io_feed", "records": IO_RECORDS, "format": "png",
          "sides": IO_SIDES, "shard_bytes": shard_bytes,
          "write_s": write_s, "iterator": IO_ITER, "host_cores": os.cpu_count(),
          "decode_threads": int(os.environ["MXNET_CPU_WORKER_NTHREADS"]),
          "feed_s": feed_s, "feed_images_per_s": n / feed_s,
          "launches": launches})
    return path, launches


class DigestHook:
    """A step probe (``FeedForward._step_probe``): an exact int64 digest of
    the batch each step read on the card, computed inside the step, so a
    captured step digests its static input buffer as the graph reads it.
    The host digests of the fit's batches are taken after the fit, so the
    probe adds no sync."""

    def __init__(self, torch, numel):
        rng = np.random.RandomState(SEED + 10)
        self.host_w = torch.from_numpy(
            rng.randint(1, 1000, numel).astype(np.int64))
        self.dev_w = self.host_w.cuda()

    def __call__(self, arrays):
        return (arrays["data"].reshape(-1).long() * self.dev_w).sum()

    def mismatches(self, probes):
        return [i for i, (batch, dev) in enumerate(probes)
                if int((batch.data[0].reshape(-1).long() * self.host_w).sum())
                != int(dev)]


def io_fit(torch, mt, net, args, aux, data, steps_floor, fault=False,
           stale=False, window=None):
    """One epoch of bf16 ResNet-50 ``FeedForward.fit`` (SGD, lr 0.01,
    momentum 0.9) from ``data``, each step's batch digested on the card
    inside the step. Step ms is the epoch's card-synced time after the
    warm-up step over the steps after it. ``fault`` plants an off-by-one
    feed; ``stale`` a captured step whose static input buffer the feed no
    longer writes after the capture. ``window = (start, stop)`` (``start``
    at least 2: the warm-up and the capture steps) also reads steps
    ``start + 1`` to ``stop``, between syncs after steps ``start`` and
    ``stop``: their ms a step, and under ``torch.profiler`` (the card's
    activity only) the card's device time and idle share over the last
    IO_PROFILE_STEPS of them, between syncs too; the profiler stops after
    the window, since stopping it holds the host."""
    from mxnet_tpu_torch import model as model_mod

    class StepLoss(mt.metric.EvalMetric):
        def __init__(self):
            super().__init__("softmax_loss")
            self.values = []
            from mxnet_tpu_torch.ops import OPS

            self.head = OPS.create("SoftmaxOutput")

        def update(self, labels, preds):
            self.values.append(self.head.loss_value(preds[0], labels[0]))

    class OffByOne(model_mod._DeviceFeed):
        """The planted fault: each step reads the previous step's batch."""

        def __iter__(self):
            prev = None
            for batch, dev in super().__iter__():
                yield batch, (dev if prev is None else prev)
                prev = dev

    metric, marks, steps_done, at = StepLoss(), [], [0], {}
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if window else None
    start, stop = window or (0, 0)
    profile_start = stop - IO_PROFILE_STEPS

    def mark(_p):
        steps_done[0] += 1
        k = steps_done[0]
        if not marks:
            torch.cuda.synchronize()  # the warm-up step ends here
            marks.append(time.perf_counter())
        if window and k in (start, profile_start, stop):
            torch.cuda.synchronize()
            at[k] = time.perf_counter()
            if k == profile_start:
                prof.start()
            if k == stop:
                prof.stop()

    hook = DigestHook(torch, int(np.prod(data.provide_data[0][1])))
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="sgd",
                           learning_rate=IO_LR, momentum=IO_MOMENTUM,
                           arg_params=args, aux_params=aux,
                           compute_dtype=torch.bfloat16)
    model._step_probe = hook
    real, real_run = model_mod._DeviceFeed, model_mod._Program.run

    def stale_run(self, arrays):
        out = real_run(self, arrays)
        if self.captured.captured and not hasattr(self, "planted"):
            # the graph keeps reading the buffers it was captured on (kept
            # alive here); the feed's copies go to new ones from here on
            self.planted = self.static
            self.static = {k: v.clone() for k, v in self.static.items()}
        return out

    if fault:
        model_mod._DeviceFeed = OffByOne
    if stale:
        model_mod._Program.run = stale_run
    try:
        model.fit(data, eval_metric=metric, batch_end_callback=mark)
    finally:
        model_mod._DeviceFeed, model_mod._Program.run = real, real_run
    torch.cuda.synchronize()
    end = time.perf_counter()
    elapsed = end - marks[0]
    n = len(model.step_probes)
    require(n >= steps_floor, f"io_fit: {n} steps, at least {steps_floor}")
    losses = [float(v) / IO_ITER["batch_size"] for v in metric.values]
    step_ms = elapsed * 1e3 / (n - 1)
    waits = model.feed_waits
    measured = {}
    if window:
        require(stop in at and profile_start >= start,
                f"io_fit: the window {window} and its {IO_PROFILE_STEPS} "
                f"profiled steps lie in the {n} steps")
        device_ms = card_device_us(torch, prof) / 1e3
        require(device_ms > 0,
                "io_fit: the profiler recorded the card's activity")
        wall_ms = (at[stop] - at[start]) * 1e3
        k = stop - start
        measured = {"window": [start + 1, stop],
                    "window_step_ms": wall_ms / k,
                    "window_images_per_s":
                        IO_ITER["batch_size"] * k * 1e3 / wall_ms,
                    "device_ms_per_step": device_ms / IO_PROFILE_STEPS,
                    "device_idle_share": 1.0 - device_ms / (
                        (at[stop] - at[profile_start]) * 1e3),
                    "window_feed_wait_ms_median":
                        statistics.median(waits[start:stop]) * 1e3}
    return model, {**measured,
        "steps": n, "step_ms": step_ms,
        "images_per_s": IO_ITER["batch_size"] * 1e3 / step_ms,
        "feed_wait_ms_median": statistics.median(waits[1:]) * 1e3,
        "feed_wait_ms_mean": float(np.mean(waits[1:])) * 1e3,
        "loss_first": losses[0], "loss_last": losses[-1],
        "finite": bool(np.isfinite(losses).all()),
        "digest_mismatches": hook.mismatches(model.step_probes)}


def cached_batches(mt, batch, steps):
    """A DataIter that yields one host batch ``steps`` times."""

    class Cached(mt.io.DataIter):
        def __init__(self):
            super().__init__()
            self.batch_size = batch.data[0].shape[0]
            self._i = 0

        def reset(self):
            self._i = 0

        def next(self):
            if self._i == steps:
                raise StopIteration
            self._i += 1
            return mt.io.DataBatch([batch.data[0]], [batch.label[0]])

        @property
        def provide_data(self):
            return [("data", tuple(batch.data[0].shape))]

        @property
        def provide_label(self):
            return [("softmax_label", tuple(batch.label[0].shape))]

    return Cached()


def xavier_resnet50(torch, mt):
    """ResNet-50 with Xavier-initialised parameters (the initializer's own
    rule for biases, BatchNorm's gamma, beta and running statistics)."""
    from mxnet_tpu_torch.models import resnet50

    net = resnet50(num_classes=1000)
    shape = (IO_ITER["batch_size"],) + IO_ITER["data_shape"]
    arg_shapes, _, aux_shapes = net.infer_shape(data=shape)
    init = mt.init.Xavier()
    args, aux = {}, {}
    for names, shapes, store in ((net.list_arguments(), arg_shapes, args),
                                 (net.list_auxiliary_states(), aux_shapes,
                                  aux)):
        for name, s in zip(names, shapes):
            if name in ("data", "softmax_label"):
                continue
            store[name] = torch.zeros(s)
            init(name, store[name])
    return net, args, aux


def phase_io_fit(torch, mt, path):
    """bf16 ResNet-50 trained from the RecordIO shard through the feed."""
    import os

    mt.set_matmul_precision("highest")
    net, args, aux = xavier_resnet50(torch, mt)
    steps_floor = IO_EPOCH_STEPS
    reset_launches()
    model, overlap = io_fit(torch, mt, net, args, aux, io_iter(mt, path),
                            steps_floor, window=IO_STEADY_WINDOW)
    launches = read_launches()
    moved = max(float((model.arg_params[k] - args[k]).abs().max())
                for k in args)
    finite = all(bool(torch.isfinite(v).all())
                 for v in model.arg_params.values())
    os.environ["MXTPU_FEED_PREFETCH"] = "0"
    try:
        _, sync = io_fit(torch, mt, net, args, aux, io_iter(mt, path),
                         steps_floor)
    finally:
        del os.environ["MXTPU_FEED_PREFETCH"]
    first = next(iter(io_iter(mt, path)))
    _, cached = io_fit(torch, mt, net, args, aux,
                       cached_batches(mt, first, overlap["steps"]),
                       steps_floor, window=IO_STEADY_WINDOW)
    _, fault = io_fit(torch, mt, net, args, aux,
                      io_iter(mt, path, num_parts=4), 4, fault=True)
    for name, row in (("overlap", overlap), ("synchronous", sync),
                      ("cached", cached)):
        require(not row["digest_mismatches"],
                f"io_fit ({name}): every step read the host batch on the "
                f"card; steps {row['digest_mismatches']} did not")
        require(row["finite"], f"io_fit ({name}): finite loss")
    require(finite and moved > 0, f"io_fit: parameters finite ({finite}) "
            f"and moved ({moved})")
    require(fault["digest_mismatches"] == list(range(1, fault["steps"])),
            "io_fit: the planted off-by-one feed is caught at every step "
            f"after the first: {fault['digest_mismatches']}")
    emit({"phase": "io_fit", "model": "resnet50", "compute_dtype": "bfloat16",
          "optimizer": f"sgd lr {IO_LR} momentum {IO_MOMENTUM}",
          "initializer": "Xavier", "overlap": overlap,
          "synchronous_feed": sync, "cached_batch": cached,
          "planted_off_by_one": {"steps": fault["steps"],
                                 "mismatched_steps":
                                 fault["digest_mismatches"]},
          "max_param_move": moved, "launches": launches})
    return launches, {"png": overlap, "cached": cached}


def set_decode_threads(mt, n):
    """``n`` decode threads: the host engine's (the Python path's; the
    engine is made anew so that it takes them) and the native route's
    default (``MXNET_CPU_WORKER_NTHREADS``)."""
    import os

    os.environ["MXNET_CPU_WORKER_NTHREADS"] = str(n)
    mt.engine.set_engine_type("ThreadedEnginePerDevice")


def write_jpeg_shard(mt, png_path, path):
    """The PNG shard's records, in order, re-encoded as JPEG by the native
    codec (PIL's bytes at quality IO_JPEG_QUALITY): the same images,
    labels, count and sides. Returns the shard's size and every 64th
    record's (index, source image, JPEG bytes)."""
    import os

    from mxnet_tpu_torch import native

    rio = mt.recordio
    with rio.MXRecordIO(png_path, "r") as reader:
        raws = []
        while (raw := reader.read()) is not None:
            raws.append(raw)

    def convert(item):
        i, raw = item
        header, img = rio.unpack_img(raw)
        jpg = native.encode_jpeg(img, IO_JPEG_QUALITY)
        return rio.pack(header, jpg), (img if i % 64 == 0 else None), jpg

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        out = list(pool.map(convert, enumerate(raws)))
    with rio.MXRecordIO(path, "w") as w:
        for rec, _, _ in out:
            w.write(rec)
    sample = [(i, img, jpg) for i, (_, img, jpg) in enumerate(out)
              if img is not None]
    return sum(len(rec) for rec, _, _ in out), [jpg for _, _, jpg in out], \
        sample


def io_codec_check(sample):
    """The native decode of sampled records against PIL's decode of the
    same bytes (exact) and against the source pixels, and the native
    encode against PIL's bytes (equal)."""
    import io as _pyio

    import PIL
    from PIL import Image

    from mxnet_tpu_torch import native

    rows = []
    for i, src, jpg in sample:
        got = native.decode_jpeg(jpg).astype(np.int32)
        err = np.abs(got - src.astype(np.int32))
        pil = np.asarray(Image.open(_pyio.BytesIO(jpg)).convert("RGB"))
        buf = _pyio.BytesIO()
        Image.fromarray(src).save(buf, format="JPEG", quality=IO_JPEG_QUALITY)
        row = {"record": i, "source_max_err": int(err.max()),
               "source_mean_err": float(err.mean()),
               "pil_max_err": int(np.abs(got - pil).max()),
               "pil_bytes_equal": buf.getvalue() == jpg}
        rows.append(row)
        require(row["source_mean_err"] < IO_SOURCE_MEAN_BOUND,
                f"io_native: record {i} decodes to its image: {row}")
        require(row["pil_max_err"] == 0 and row["pil_bytes_equal"],
                f"io_native: record {i}'s bytes and pixels are PIL's: {row}")
    return {"pil": PIL.__version__, "records": rows}


def io_native_deterministic(torch, mt, path, jpegs):
    """No random augmentation, no shuffle, centre crops with no resize
    (every side exceeds the crop's), batch 30 (the last batch padded from the epoch's start): every batch
    bitwise between 1 and 8 pipeline threads, and against the native
    decode of each record alone (a thread pool of ``decode_jpeg`` calls,
    no pipeline), cropped here; labels in order and the pads."""
    import os

    from mxnet_tpu_torch import native

    _, ch, cw = IO_ITER["data_shape"]  # below every side: no resize
    kw = dict(path_imgrec=path, data_shape=IO_ITER["data_shape"],
              batch_size=30, output_dtype="uint8", prefetch_buffer=8)
    one = mt.io.ImageRecordIter(preprocess_threads=1, **kw)
    eight = mt.io.ImageRecordIter(preprocess_threads=8, **kw)
    require(one._native is not None and eight._native is not None,
            "io_native: the deterministic iterators take the native route")
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        decoded = list(pool.map(native.decode_jpeg, jpegs))
    n, batches, pads, mismatches = len(jpegs), 0, [], []
    for b, (x, y) in enumerate(zip(one, eight)):
        require(torch.equal(x.data[0], y.data[0])
                and torch.equal(x.label[0], y.label[0]) and x.pad == y.pad,
                f"io_native: batch {b} bitwise between 1 and 8 threads")
        for r in range(30):
            idx = (b * 30 + r) % n
            img = decoded[idx]
            h, w = img.shape[:2]
            top, left = (h - ch) // 2, (w - cw) // 2
            want = torch.from_numpy(np.ascontiguousarray(
                img[top:top + ch, left:left + cw].transpose(2, 0, 1)))
            if not (torch.equal(x.data[0][r], want)
                    and float(x.label[0][r]) == float(idx % 1000)):
                mismatches.append((b, r))
        pads.append(x.pad)
        batches += 1
    want_batches = -(-n // 30)
    want_pads = [0] * (want_batches - 1) + [want_batches * 30 - n]
    require(batches == want_batches and pads == want_pads,
            f"io_native: {batches} batches with pads {pads}, the reference's "
            f"round_batch gives {want_batches} with {want_pads}")
    require(not mismatches, "io_native: every image and label is the "
            f"record's own decode and label in order: {mismatches[:5]}")
    return {"batches": batches, "last_pad": pads[-1],
            "bitwise_1_vs_8_threads": True,
            "bitwise_vs_decode_alone": True}


def phase_io_native(torch, mt, png_path, io_fit_rows):
    """The JPEG shard through the native pipeline: the codec, the route,
    determinism, feed-only images/s, io_fit against the PNG shard and the
    cached batch (``io_fit_rows``, phase io_fit's), and the decode-thread
    sweep on both shards."""
    import os

    path = os.path.join(IO_DIR, "shard_jpeg.rec")
    t0 = time.perf_counter()
    shard_bytes, jpegs, sample = write_jpeg_shard(mt, png_path, path)
    write_s = time.perf_counter() - t0
    codec = io_codec_check(sample)
    require(io_iter(mt, path)._native is not None,
            "io_native: ImageRecordIter takes the native route on the JPEG "
            "shard (no Python fallback)")
    feed = {}
    for t in IO_THREADS:
        it = io_iter(mt, path, preprocess_threads=t)
        require(it._native is not None and it._native.num_threads == t,
                f"io_native: the native route with {t} threads")
        t0 = time.perf_counter()
        n = sum(b.data[0].shape[0] for b in it)
        dt = time.perf_counter() - t0
        require(n == IO_RECORDS, f"io_native: one epoch, {n} images")
        feed[t] = {"feed_s": dt, "images_per_s": n / dt}
    determinism = io_native_deterministic(torch, mt, path, jpegs)
    del jpegs

    mt.set_matmul_precision("highest")
    net, args, aux = xavier_resnet50(torch, mt)
    set_decode_threads(mt, os.cpu_count())
    reset_launches()
    # the main path: bf16 ResNet-50 trained from the JPEG shard
    data = io_iter(mt, path)
    require(data._native is not None, "io_native: the fit's iterator takes "
            "the native route")
    model, jpeg_fit = io_fit(torch, mt, net, args, aux, data,
                             IO_EPOCH_STEPS, window=IO_STEADY_WINDOW)
    launches = read_launches()
    moved = max(float((model.arg_params[k] - args[k]).abs().max())
                for k in args)
    del model
    keys = ("window", "window_step_ms", "window_images_per_s",
            "device_ms_per_step", "device_idle_share",
            "window_feed_wait_ms_median", "step_ms", "feed_wait_ms_median")
    cores = os.cpu_count()
    # the sweep's row at the host's cores: the whole-epoch fits above
    sweep = {"png": {cores: {k: io_fit_rows["png"][k] for k in keys}},
             "jpeg": {cores: {k: jpeg_fit[k] for k in keys}}}
    for t in (t for t in IO_SWEEP_THREADS if t < cores):
        set_decode_threads(mt, t)
        for fmt, p in (("png", png_path), ("jpeg", path)):
            it = io_iter(mt, p, num_parts=IO_SWEEP_PARTS, prefetch_buffer=t)
            require((it._native is not None) == (fmt == "jpeg"),
                    f"io_native sweep: the {fmt} shard's route")
            _, r = io_fit(torch, mt, net, args, aux, it, IO_SWEEP_WINDOW[1],
                          window=IO_SWEEP_WINDOW)
            require(not r["digest_mismatches"] and r["finite"],
                    f"io_native sweep ({fmt}, {t} threads): {r}")
            sweep[fmt][t] = {k: r[k] for k in keys}
    set_decode_threads(mt, cores)
    require(not jpeg_fit["digest_mismatches"],
            "io_native: every step read the host batch on the card; steps "
            f"{jpeg_fit['digest_mismatches']} did not")
    require(jpeg_fit["finite"], "io_native: finite loss")
    require(moved > 0, f"io_native: the parameters moved ({moved})")
    emit({"phase": "io_native", "records": IO_RECORDS, "format": "jpeg",
          "quality": IO_JPEG_QUALITY, "shard_bytes": shard_bytes,
          "write_s": write_s, "codec": codec,
          "bounds": {"pil": "bytes and pixels equal",
                     "source_mean": IO_SOURCE_MEAN_BOUND},
          "feed_only": feed, "deterministic": determinism,
          "io_fit_jpeg": {k: v for k, v in jpeg_fit.items()
                          if k != "digest_mismatches"},
          "cached_batch": {k: io_fit_rows["cached"][k] for k in keys},
          "thread_sweep": sweep, "host_cores": cores,
          "sweep_settings": {"below_cores": {"num_parts": IO_SWEEP_PARTS,
                                             "prefetch_buffer": "threads",
                                             "window": IO_SWEEP_WINDOW},
                             "cores": {"prefetch_buffer":
                                       IO_ITER["prefetch_buffer"],
                                       "window": IO_STEADY_WINDOW}},
          "launches": launches})
    return launches


def pil_progressive(img, quality, subsampling):
    import io as _pyio

    from PIL import Image

    buf = _pyio.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality,
                              subsampling=subsampling, progressive=True)
    return buf.getvalue()


def phase_native_progressive(torch, mt, png_path):
    """The native codec on progressive JPEG: records of the PNG shard
    re-encoded by PIL as progressive decode to PIL's pixels exactly; a
    shard mixing baseline and progressive records (progressive ones from
    the third batch on) keeps ``ImageRecordIter`` on the native route for a
    whole epoch, its batches bitwise each record decoded alone. No kernel
    runs on this path."""
    import io as _pyio
    import os

    import PIL
    from PIL import Image

    from mxnet_tpu_torch import native

    rio = mt.recordio
    with rio.MXRecordIO(png_path, "r") as reader:
        raws = []
        while len(raws) < PROGRESSIVE_RECORDS and \
                (raw := reader.read()) is not None:
            raws.append(raw)
    images = [rio.unpack_img(r) for r in raws]
    step = len(images) // PROGRESSIVE_SAMPLE
    checked, decode_s = [], {"progressive": 0.0, "baseline": 0.0}
    for j in range(PROGRESSIVE_SAMPLE):
        img = images[j * step][1]
        quality, sub = (95, 75, 50)[j % 3], (0, 1, 2)[j % 3]
        data = pil_progressive(img, quality, sub)
        want = np.asarray(Image.open(_pyio.BytesIO(data)).convert("RGB"))
        t0 = time.perf_counter()
        got = native.decode_jpeg(data)
        decode_s["progressive"] += time.perf_counter() - t0
        base = native.encode_jpeg(img, quality)
        t0 = time.perf_counter()
        native.decode_jpeg(base)
        decode_s["baseline"] += time.perf_counter() - t0
        err = int(np.abs(got.astype(np.int32) - want).max())
        require(err == 0, f"native_progressive: record {j * step} "
                f"(quality {quality}, subsampling {sub}) decodes to PIL's "
                f"pixels exactly: {err}")
        checked.append({"record": j * step, "quality": quality,
                        "subsampling": sub, "bytes": len(data),
                        "pil_max_err": err})

    # the mixed shard
    path = os.path.join(IO_DIR, "shard_mixed.rec")

    def convert(item):
        i, (header, img) = item
        jpg = pil_progressive(img, IO_JPEG_QUALITY, 2) \
            if i >= PROGRESSIVE_FIRST and i % 2 == 0 \
            else native.encode_jpeg(img, IO_JPEG_QUALITY)
        return rio.pack(header, jpg), jpg

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        out = list(pool.map(convert, enumerate(images)))
    with rio.MXRecordIO(path, "w") as w:
        for rec, _ in out:
            w.write(rec)
    jpegs = [jpg for _, jpg in out]
    progressive = sum(b"\xff\xc2" in j[:2048] for j in jpegs)
    kw = dict(path_imgrec=path, data_shape=IO_ITER["data_shape"],
              batch_size=BATCH, output_dtype="uint8", preprocess_threads=4,
              prefetch_buffer=4)
    it = mt.io.ImageRecordIter(**kw)
    require(it._native is not None,
            "native_progressive: the mixed shard takes the native route")
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        decoded = list(pool.map(native.decode_jpeg, jpegs))
    _, ch, cw = IO_ITER["data_shape"]
    batches, mismatches = 0, []
    reset_launches()
    # the main path: an epoch of the mixed shard through the native route
    t0 = time.perf_counter()
    for b, batch in enumerate(it):
        for r in range(BATCH - batch.pad):
            img = decoded[b * BATCH + r]
            h, w = img.shape[:2]
            top, left = (h - ch) // 2, (w - cw) // 2
            want = torch.from_numpy(np.ascontiguousarray(
                img[top:top + ch, left:left + cw].transpose(2, 0, 1)))
            if not torch.equal(batch.data[0][r], want):
                mismatches.append((b, r))
        batches += 1
    epoch_s = time.perf_counter() - t0
    launches = read_launches()
    require(it._native is not None and batches == len(jpegs) // BATCH,
            f"native_progressive: one epoch of {batches} batches on the "
            "native route")
    require(not mismatches, "native_progressive: every image of the mixed "
            f"shard is its record's own decode: {mismatches[:5]}")
    emit({"phase": "native_progressive", "pil": PIL.__version__,
          "sample": checked, "pil_pixels_exact": True,
          "decode_ms_per_image": {k: v * 1e3 / PROGRESSIVE_SAMPLE
                                  for k, v in decode_s.items()},
          "mixed_shard": {"records": len(jpegs),
                          "progressive_records": progressive,
                          "first_progressive": PROGRESSIVE_FIRST,
                          "batches": batches, "native_route": True,
                          "bitwise_vs_decode_alone": True,
                          "epoch_s": epoch_s}, "launches": launches})
    return launches


def phase_native_arith(torch, mt, png_path):
    """The native codec on arithmetic-coded JPEG: the carried files decode
    to PIL's pixels where this machine's PIL reads arithmetic coding, else
    to the carried digests of PIL's pixels where they were written; a shard
    of the PNG shard's images as Huffman records, with the carried files
    as every other record from the second batch on, keeps
    ``ImageRecordIter`` on the native route for a whole epoch, its batches
    bitwise each record decoded alone. No kernel runs on this path."""
    import hashlib
    import importlib.util
    import io as _pyio
    import os

    from pathlib import Path

    import PIL
    from PIL import Image

    from mxnet_tpu_torch import native

    path = Path(__file__).resolve().parent / "tests" / "torch_arith_jpeg.py"
    spec = importlib.util.spec_from_file_location("torch_arith_jpeg", path)
    carried = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(carried)
    files = carried.arith_jpegs()
    checked = {}
    for name, data in sorted(files.items()):
        got = native.decode_jpeg(data)
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        try:
            want = np.asarray(Image.open(_pyio.BytesIO(data)).convert("RGB"))
            against = f"PIL {PIL.__version__}"
            same = got.shape == want.shape and bool((got == want).all())
        except OSError as e:  # a PIL without arithmetic decoding
            against = f"the carried digest (PIL {PIL.__version__}: {e})"
            same = digest == carried.PIXEL_SHA256[name]
        require(same and digest == carried.PIXEL_SHA256[name],
                f"native_arith: {name} decodes to {against}'s pixels exactly")
        checked[name] = {"bytes": len(data), "against": against,
                         "pixels_exact": True}

    # the mixed shard: Huffman records (the port's encoder) with the
    # carried arithmetic files as every other record from the second batch
    rio = mt.recordio
    ordered = [files[k] for k in sorted(files)]
    n = 4 * BATCH
    with rio.MXRecordIO(png_path, "r") as reader:
        images = [rio.unpack_img(reader.read())[1] for _ in range(n)]
    jpegs = [ordered[(i // 2) % len(ordered)]
             if i >= BATCH and i % 2 == 0
             else native.encode_jpeg(images[i], IO_JPEG_QUALITY)
             for i in range(n)]
    shard = os.path.join(IO_DIR, "shard_arith.rec")
    with rio.MXRecordIO(shard, "w") as w:
        for i, jpg in enumerate(jpegs):
            w.write(rio.pack(rio.IRHeader(0, float(i), i, 0), jpg))
    # the carried images are 67 x 45: crop what every record holds
    shape = (3, 40, 40)
    it = mt.io.ImageRecordIter(path_imgrec=shard, data_shape=shape,
                               batch_size=BATCH, output_dtype="uint8",
                               preprocess_threads=4, prefetch_buffer=4)
    require(it._native is not None,
            "native_arith: the mixed shard takes the native route")
    decoded = [native.decode_jpeg(j) for j in jpegs]
    _, ch, cw = shape
    batches, mismatches = 0, []
    reset_launches()
    # the main path: an epoch of the mixed shard through the native route
    t0 = time.perf_counter()
    for b, batch in enumerate(it):
        for r in range(BATCH - batch.pad):
            img = decoded[b * BATCH + r]
            h, w = img.shape[:2]
            top, left = (h - ch) // 2, (w - cw) // 2
            want = torch.from_numpy(np.ascontiguousarray(
                img[top:top + ch, left:left + cw].transpose(2, 0, 1)))
            if not torch.equal(batch.data[0][r], want):
                mismatches.append((b, r))
        batches += 1
    epoch_s = time.perf_counter() - t0
    launches = read_launches()
    require(it._native is not None and batches == n // BATCH,
            f"native_arith: one epoch of {batches} batches on the native "
            "route")
    require(not mismatches, "native_arith: every image of the mixed shard "
            f"is its record's own decode: {mismatches[:5]}")
    arith_records = sum(j[:2048].find(b"\xff\xc9") >= 0
                        or j[:2048].find(b"\xff\xca") >= 0 for j in jpegs)
    emit({"phase": "native_arith", "pil": PIL.__version__, "files": checked,
          "mixed_shard": {"records": n, "arithmetic_records": arith_records,
                          "batches": batches, "native_route": True,
                          "bitwise_vs_decode_alone": True,
                          "epoch_s": epoch_s}, "launches": launches})
    return launches


def lstm_sentences(count=LSTM_SENTENCES):
    """The synthetic corpus of ``count`` sentences: lengths uniform over
    ``LSTM_LENGTHS``, ids with Zipf(``LSTM_ZIPF``) frequencies over a fixed
    order of the vocabulary (the repository holds no PTB text)."""
    rng = np.random.default_rng(SEED + 11)
    vocab = LSTM_CONFIG["vocab"]
    freq = 1.0 / np.arange(1, vocab + 1) ** LSTM_ZIPF
    order = rng.permutation(vocab)
    lengths = rng.integers(LSTM_LENGTHS[0], LSTM_LENGTHS[1] + 1,
                           count)
    ids = order[rng.choice(vocab, size=int(lengths.sum()),
                           p=freq / freq.sum())]
    return np.split(ids.astype(np.int32), np.cumsum(lengths)[:-1])


def lstm_sym_gen(mt):
    cfg = LSTM_CONFIG

    def gen(seq_len):
        return mt.models.lstm_unroll(
            cfg["num_layers"], seq_len, cfg["vocab"], cfg["num_hidden"],
            cfg["num_embed"], cfg["vocab"])
    return gen


def lstm_states():
    cfg = LSTM_CONFIG
    return [(f"l{i}_init_{k}", (LSTM_BATCH, cfg["num_hidden"]))
            for i in range(cfg["num_layers"]) for k in ("c", "h")]


def lstm_args(mt):
    from mxnet_tpu_torch.convert import random_params

    top = LSTM_BUCKETS[-1]
    shapes = {f"t{t}_data": (LSTM_BATCH,) for t in range(top)}
    shapes.update(dict(lstm_states()))
    return random_params(lstm_sym_gen(mt)(top), SEED, **shapes)[0]


def lstm_nll(torch, labels, preds):
    """Mean negative log-likelihood over a batch's steps and rows."""
    nll = [-torch.log(torch.gather(p.float(), 1, lab.long().to(p.device)[
        :, None])[:, 0] + 1e-12) for lab, p in zip(labels, preds)]
    return torch.stack(nll).mean()


def bucket_module(mt, ctx, args, it, fault=False):
    """A BucketingModule over ``lstm_unroll`` bound and initialised from
    ``args``; with ``fault``, each bucket's executor holds copies of the
    default bucket's weights (the planted fault)."""
    base = mt.mod.BucketingModule

    class Copying(base):
        def _executor_for(self, key, shapes):
            ex = super()._executor_for(key, shapes)
            for n in args:
                ex.arg_dict[n] = ex.arg_dict[n].clone()
            return ex

    mod = (Copying if fault else base)(lstm_sym_gen(mt),
                                       default_bucket_key=LSTM_BUCKETS[-1],
                                       context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=args, aux_params={})
    return mod


def bucket_sharing(torch, mt, args, batches, fault):
    """One step on the shortest bucket, then whether the longest bucket's
    executor reads the updated weights bitwise."""
    it = mt.bucketing.BucketSentenceIter([], buckets=LSTM_BUCKETS,
                                         batch_size=LSTM_BATCH,
                                         init_states=lstm_states())
    mod = bucket_module(mt, mt.gpu(0), args, it, fault=fault)
    mod.init_optimizer(optimizer_params=LSTM_OPT)
    short, long_ = batches[LSTM_BUCKETS[0]], batches[LSTM_BUCKETS[-2]]
    mod.forward(long_, is_train=False)  # binds the long bucket first
    mod.forward(short, is_train=True)
    mod.backward()
    mod.update()
    ex = mod._bucket_execs[LSTM_BUCKETS[-2]]
    master = mod._default_exec.arg_dict
    moved = not torch.equal(master["cls_weight"].cpu(),
                            torch.from_numpy(args["cls_weight"]))
    return moved, all(torch.equal(ex.arg_dict[n], master[n]) for n in args)


def phase_lstm_bucketing(torch, mt):
    """BucketingModule.fit of lstm_unroll at the PTB example's widths."""
    mt.set_matmul_precision("highest")
    args = lstm_args(mt)
    sents = lstm_sentences()
    it = mt.bucketing.BucketSentenceIter(sents, buckets=LSTM_BUCKETS,
                                         batch_size=LSTM_BATCH,
                                         init_states=lstm_states(), seed=SEED)

    class StepNLL(mt.metric.EvalMetric):
        def __init__(self):
            super().__init__("nll")
            self.values, self.keys = [], []

        def update(self, labels, preds):
            self.keys.append(len(labels))
            self.values.append(lstm_nll(torch, labels, preds))

    metric, stamps = StepNLL(), []

    def stamp(_p):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    mod = bucket_module(mt, mt.gpu(0), args, it)
    seen_batches = []
    forward = mod.forward

    def first_forward(batch, is_train=None):
        out = forward(batch, is_train)
        if not seen_batches:
            seen_batches.append((batch, [o.clone() for o in mod.get_outputs()[
                :len(batch.label)]]))
        return out

    mod.forward = first_forward  # keeps the first batch fit trains on
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, eval_metric=metric, optimizer="sgd",
            optimizer_params=LSTM_OPT, batch_end_callback=stamp)
    launches = read_launches()
    losses = [float(v) for v in metric.values]
    step_ms = np.diff([t0] + stamps) * 1e3
    per_bucket = {}
    seen = set()
    for key, ms in zip(metric.keys, step_ms):
        if key in seen:  # the first step of a bucket binds its executor
            per_bucket.setdefault(key, []).append(float(ms))
        seen.add(key)
    bucket_row = {k: {"steps": len(v) + 1, "step_ms_median":
                      statistics.median(v),
                      "tokens_per_s": LSTM_BATCH * k * 1e3
                      / statistics.median(v)}
                  for k, v in sorted(per_bucket.items())}
    # the first step against the same step on the CPU
    first, first_outs = seen_batches[0]
    cpu_mod = bucket_module(mt, mt.cpu(), args, it)
    cpu_mod.forward(first, is_train=True)
    cpu_outs = cpu_mod.get_outputs()[:len(first.label)]
    cpu_loss = float(lstm_nll(torch, first.label, cpu_outs))
    first_err = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    probs_err = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(first_outs, cpu_outs))
    require(np.isfinite(losses).all(), "lstm_bucketing: finite losses")
    require(first_err < LSTM_CPU_BOUND,
            f"lstm_bucketing: the first step's loss {losses[0]} against the "
            f"CPU's {cpu_loss} ({first_err} relative, bound {LSTM_CPU_BOUND})")
    require(set(mod._bucket_execs) == set(LSTM_BUCKETS),
            f"lstm_bucketing: every bucket ran: {sorted(mod._bucket_execs)}")
    batches = {}
    for b in mt.bucketing.BucketSentenceIter(
            sents, buckets=LSTM_BUCKETS, batch_size=LSTM_BATCH,
            init_states=lstm_states(), shuffle=False):
        batches.setdefault(b.bucket_key, b)
    moved, shared = bucket_sharing(torch, mt, args, batches, fault=False)
    f_moved, f_shared = bucket_sharing(torch, mt, args, batches, fault=True)
    require(moved and shared, "lstm_bucketing: after a step on bucket "
            f"{LSTM_BUCKETS[0]}, bucket {LSTM_BUCKETS[-2]}'s executor reads "
            f"the updated weights bitwise (moved {moved}, shared {shared})")
    require(f_moved and not f_shared, "lstm_bucketing: the planted fault "
            "(a bucket copies its weights) is caught")
    emit({"phase": "lstm_bucketing", "config": LSTM_CONFIG,
          "buckets": LSTM_BUCKETS, "batch": LSTM_BATCH,
          "optimizer": LSTM_OPT, "corpus": {
              "sentences": LSTM_SENTENCES, "lengths": LSTM_LENGTHS,
              "zipf": LSTM_ZIPF, "discarded": it.discarded},
          "steps": len(losses), "loss_first": losses[0],
          "loss_last": losses[-1], "cpu_first_loss": cpu_loss,
          "first_loss_rel_err": first_err,
          "first_probs_max_abs_err": probs_err, "per_bucket": bucket_row,
          "epoch_s": float(step_ms.sum() / 1e3),
          "planted_copy_caught": not f_shared, "launches": launches})
    return launches


def phase_lstm_scan(torch, mt):
    """LSTMLM (the time loop in torch) at the same widths: forward and 8
    SGD-momentum steps on the card, held against the CPU."""
    from mxnet_tpu_torch.models import LSTMLM

    mt.set_matmul_precision("highest")
    cfg = LSTM_CONFIG
    model = LSTMLM(cfg["vocab"], num_embed=cfg["num_embed"],
                   num_hidden=cfg["num_hidden"], num_layers=cfg["num_layers"])
    rng = np.random.default_rng(SEED + 12)
    ids = rng.integers(0, cfg["vocab"], (LSTM_BATCH, LSTM_SCAN_SEQ + 1))
    tokens = torch.from_numpy(ids[:, :-1].astype(np.int32))
    targets = torch.from_numpy(ids[:, 1:].astype(np.int32))
    params = model.init_params(SEED, ctx=mt.gpu(0))
    cpu_params = {k: v.cpu().clone() for k, v in params.items()}
    tok, tgt = tokens.cuda(), targets.cuda()
    reset_launches()
    with torch.no_grad():
        logits, _ = model.forward(params, tok)
        fwd_ms = []
        for _ in range(5):  # wall time: the time loop is launch-bound
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.forward(params, tok)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        fwd_ms = statistics.median(fwd_ms)
        cpu_logits, _ = model.forward(cpu_params, tokens)
    logit_err = float((logits.cpu() - cpu_logits).abs().max())
    step = model.make_train_step(lr=LSTM_SCAN_LR, momentum=0.9)
    moms = model.init_optimizer(params)
    cpu_moms = model.init_optimizer(cpu_params)
    losses, marks = [], []
    for i in range(LSTM_SCAN_STEPS):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        params, moms, loss = step(params, moms, tok, tgt)
        losses.append(loss)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    launches = read_launches()
    losses = [float(v) for v in losses]
    # one CPU step from the same start, against the card's first
    cpu_step = model.make_train_step(lr=LSTM_SCAN_LR, momentum=0.9)
    _, _, cpu_loss = cpu_step(cpu_params, cpu_moms, tokens, targets)
    loss_err = abs(losses[0] - float(cpu_loss)) / float(cpu_loss)
    step_ms = np.diff(marks)[1:] * 1e3
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f"lstm_scan: finite losses that fell: {losses}")
    require(logit_err < LSTM_SCAN_LOGIT_BOUND,
            f"lstm_scan: logits against the CPU's, {logit_err} (bound "
            f"{LSTM_SCAN_LOGIT_BOUND})")
    require(loss_err < LSTM_CPU_BOUND,
            f"lstm_scan: the first step's loss against the CPU's, "
            f"{loss_err} relative (bound {LSTM_CPU_BOUND})")
    tokens_n = LSTM_BATCH * LSTM_SCAN_SEQ
    emit({"phase": "lstm_scan", "config": LSTM_CONFIG, "batch": LSTM_BATCH,
          "seq": LSTM_SCAN_SEQ, "forward_ms": fwd_ms,
          "forward_tokens_per_s": tokens_n * 1e3 / fwd_ms,
          "logits_max_abs_err_vs_cpu": logit_err, "losses": losses,
          "first_loss_rel_err_vs_cpu": loss_err,
          "step_ms_median": float(np.median(step_ms)),
          "train_tokens_per_s": tokens_n * 1e3 / float(np.median(step_ms)),
          "launches": launches})
    return launches


# -- slice 11: captured steps and checkpoints --------------------------------


def set_graphs(on):
    import os

    os.environ["MXTPU_CUDA_GRAPHS"] = "1" if on else "0"


def max_gap(torch, a, b):
    """The largest absolute difference between two parameter dicts."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def moved_gap(torch, init, a, b):
    """How far run ``a``'s parameters lie from run ``b``'s, over how far
    ``b``'s moved from ``init``: ||a - b|| / ||b - init|| over every leaf.
    A run whose step stops updating reads about the share of the movement
    it missed; a run that follows ``b`` reads what rounding leaves."""
    num = den = 0.0
    for k in b:
        bk = b[k].double()
        num += float(((a[k].double() - bk) ** 2).sum())
        den += float(((bk - torch.as_tensor(init[k]).double()) ** 2).sum())
    return (num / den) ** 0.5


def planted_no_update(mt):
    """A captured step that never updates: the optimizer's in-place update
    is left out of every capture (the eager warm-up step still runs it)."""
    import contextlib

    @contextlib.contextmanager
    def plant():
        import torch

        cls = mt.optimizer.Adam
        real = cls.apply_inplace

        def skip_in_capture(self, *args, **kwargs):
            if not torch.cuda.is_current_stream_capturing():
                real(self, *args, **kwargs)

        cls.apply_inplace = skip_in_capture
        try:
            yield
        finally:
            cls.apply_inplace = real
    return plant


def planted_baked_values():
    """A captured step whose per-step values stay those of the capture
    step: the step vector is not refreshed after the second step (the
    warm-up, then the capture), so lr, c1 and c2 are baked in."""
    import contextlib

    from mxnet_tpu_torch import model as model_mod

    @contextlib.contextmanager
    def plant():
        real, calls = model_mod._StepScalars.load, [0]

        def frozen(self, values):
            calls[0] += 1
            if calls[0] <= 2:
                real(self, values)

        model_mod._StepScalars.load = frozen
        try:
            yield
        finally:
            model_mod._StepScalars.load = real
    return plant


def graph_stats(tcm):
    st = tcm.compile_stats()
    return {k: st[k] for k in ("captures", "capture_seconds", "pool_bytes",
                               "replays", "eager")}


def step_profile(torch, model, arrays, captured):
    """Device time and the card's idle share of 3 more steps of ``model``'s
    training state after its fit, replayed from the graph or eager
    (torch.profiler)."""
    state = model._train_state
    progs = [p for p in state.programs.values() if p.captured.captured]

    def step():
        state.prepare(LEARNING_RATE)
        if captured:
            progs[0].run(arrays)
        else:
            state.step(arrays)

    step()
    torch.cuda.synchronize()
    return card_report(torch, step, 3, "step")


def graphs_fit(torch, mt, tcm, net, args, aux, data, captured, batch,
               steps, **model_kw):
    """One fit of ``steps`` steps from ``data`` on the card, captured or
    eager (``MXTPU_CUDA_GRAPHS``), each step synchronized; the step time is
    the median of the steps after the warm-up and capture steps."""
    set_graphs(captured)
    tcm.reset_compile_stats()
    reset_launches()
    metric, stamps = step_loss_metric(mt), []
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1,
                           arg_params=args, aux_params=aux, **model_kw)

    def stamp(_p):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    model.fit(data, eval_metric=metric, batch_end_callback=stamp)
    launches = read_launches()
    ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    require(len(metric.steps) == steps and np.isfinite(metric.steps).all(),
            f"graphs: {steps} finite steps: {metric.steps}")
    return model, {"step_ms_median": statistics.median(ms),
                   "images_per_s": batch * 1e3 / statistics.median(ms),
                   "loss_first": metric.steps[0],
                   "loss_last": metric.steps[-1], **graph_stats(tcm),
                   "launches": launches}


def resnet_ab(torch, mt, tcm, net, args, aux, data_fn, batch_dev, steps,
              what, plants=None, **model_kw):
    """Captured, eager and eager again: the three rows, the gaps between
    their parameters and the gates (captured within twice the eager runs'
    spread, as the largest difference and as :func:`moved_gap`), and each
    run's device time and idle share. Each of ``plants`` (name: a context
    manager that plants a fault in the captured step) is one more
    captured fit, whose moved gap must read above the bound."""
    rows, params = {}, {}
    for name, captured in (("captured", True), ("eager", False),
                           ("eager_again", False)):
        model, rows[name] = graphs_fit(torch, mt, tcm, net, args, aux,
                                       data_fn(), captured, BATCH, steps,
                                       **model_kw)
        params[name] = dict(model.arg_params)
        if name != "eager_again":
            rows[name].update(step_profile(torch, model, batch_dev, captured))
        del model
        torch.cuda.empty_cache()
    spread = max_gap(torch, params["eager"], params["eager_again"])
    gap = max_gap(torch, params["captured"], params["eager"])
    require(gap <= 2 * spread,
            f"graphs {what}: captured vs eager after {steps} steps {gap}, "
            f"beyond twice the eager runs' spread {spread}")
    moved_spread = moved_gap(torch, args, params["eager_again"],
                             params["eager"])
    moved = moved_gap(torch, args, params["captured"], params["eager"])
    require(moved <= 2 * moved_spread,
            f"graphs {what}: captured vs eager after {steps} steps moved "
            f"{moved} apart, beyond twice the eager runs' {moved_spread}")
    planted = {}
    for name, plant in (plants or {}).items():
        with plant():
            model, _ = graphs_fit(torch, mt, tcm, net, args, aux, data_fn(),
                                  True, BATCH, steps, **model_kw)
        planted[name] = moved_gap(torch, args, dict(model.arg_params),
                                  params["eager"])
        del model
        torch.cuda.empty_cache()
        require(planted[name] > 2 * moved_spread,
                f"graphs {what}: the planted {name} step reads above the "
                f"bound: {planted[name]} against {2 * moved_spread}")
    require(rows["captured"]["captures"] == 1
            and rows["captured"]["replays"] == steps - 1
            and rows["eager"]["eager"] == {"MXTPU_CUDA_GRAPHS=0": 1},
            f"graphs {what}: one capture and {steps - 1} replays, the eager "
            f"run counted with its reason: {rows}")
    return rows, {"captured_vs_eager": gap, "eager_vs_eager": spread,
                  "moved_captured_vs_eager": moved,
                  "moved_eager_vs_eager": moved_spread,
                  "moved_bound": 2 * moved_spread,
                  "planted_moved": planted}, params["captured"]


def adam_replay_check(torch, kfa, tcm):
    """fused_adam captured with its per-step vector refreshed before each
    replay (a FactorScheduler halving lr every 2 steps, Adam's bias
    corrections moving) against the eager wrapper on the same gradients,
    bitwise over 8 steps at ResNet-50's 161 leaves; and a planted graph
    that bakes the first step's lr, c1 and c2 in."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 20)
    shapes = list(resnet50_leaf_shapes().values())

    def leaves(scale=1.0):
        return [torch.randn(s, generator=gen, device="cuda") * scale
                for s in shapes]

    w0, grads = leaves(), [leaves(2.0 * BATCH) for _ in range(8)]
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, rescale_grad=1 / BATCH,
                 clip_gradient=None, wd_l2=1e-4, decoupled=False)
    sched = __import__("mxnet_tpu_torch").lr_scheduler.FactorScheduler(
        step=2, factor=0.5, base_lr=LEARNING_RATE)
    n = len(shapes)
    runs = {}
    for name in ("eager", "captured", "baked"):
        w = [t.clone() for t in w0]
        m = [torch.zeros_like(t) for t in w0]
        v = [torch.zeros_like(t) for t in w0]
        g_static = [t.clone() for t in grads[0]]
        scal = torch.zeros(kfa.HEADER + kfa.PER_LEAF * n, device="cuda")
        table = kfa.LeafTable()
        first = None

        def step(w=w, m=m, v=v, g=g_static, scal=scal, table=table):
            kfa.fused_adam_step(w, g, m, v, scal, table=table, **hyper)

        prog = tcm.CapturedProgram(step, "cuda", f"unit:adam_{name}",
                                   warmup=1)
        before = kfa.fused_adam.launches
        for t in range(1, 9):
            lr = sched(t - 1)
            c1 = [float(np.float32(1) - np.float32(0.9) ** np.float32(t))] * n
            c2 = [float(np.float32(1) - np.float32(0.999) ** np.float32(t))] * n
            values = torch.from_numpy(kfa.step_vector(lr, c1, c2, [0.0] * n))
            first = values if first is None else first
            if name == "eager":
                kfa.fused_adam(w, grads[t - 1], m, v, c1, c2, [0.0] * n,
                               lr=lr, table=table, **hyper)
                continue
            for dst, src in zip(g_static, grads[t - 1]):
                dst.copy_(src)
            scal.copy_((first if name == "baked" else values).to("cuda"))
            prog()
        torch.cuda.synchronize()
        runs[name] = (w, m, v, kfa.fused_adam.launches - before)
    eq = all(torch.equal(a, b) for i in range(3)
             for a, b in zip(runs["eager"][i], runs["captured"][i]))
    baked = max(float((a - b).abs().max())
                for a, b in zip(runs["eager"][0], runs["baked"][0]))
    require(eq, "graphs: fused_adam replayed with the per-step vector is "
            "bitwise the eager launches (params, m, v) over 8 steps")
    require(runs["captured"][3] == 8,
            f"graphs: 8 fused_adam launches counted, {runs['captured'][3]}")
    require(baked > 1e-6, "graphs: the planted graph with lr, c1 and c2 "
            f"baked in at its capture reads above the bound: {baked}")
    return {"leaves": n, "steps": 8, "bitwise": eq,
            "launches_counted": runs["captured"][3],
            "planted_baked_max_abs": baked, "bound": 0.0}


def int8_replay_check(torch, k8, tcm):
    """int8_matmul captured (its row pre-pass, then the GEMM behind it by
    programmatic dependent launch) and replayed on 8 inputs, each bitwise
    its plain version, after the allocator's free memory was filled with
    NaN."""
    M, K, N = MAIN_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    w = torch.randn(N, K, generator=gen, device="cuda")
    wq, sw = k8.quantize_channels(w)
    x = torch.empty(M, K, device="cuda")
    poison = torch.full((1 << 28,), float("nan"), device="cuda")
    del poison  # its blocks return to the allocator full of NaN
    prog = tcm.CapturedProgram(lambda: k8.int8_matmul(x, wq, w_scale=sw),
                               "cuda", "unit:int8", warmup=1)
    before = k8.int8_matmul.launches
    ok = True
    for i in range(9):
        x.copy_(torch.randn(M, K, generator=gen, device="cuda"))
        y = prog().clone()
        ok = ok and torch.equal(y, k8.int8_matmul_plain(x, wq, sw))
    torch.cuda.synchronize()
    launches = k8.int8_matmul.launches - before
    require(ok, "graphs: int8_matmul replayed is bitwise its plain version "
            "on 9 inputs after a NaN-filled allocator")
    require(launches == 9, f"graphs: 9 int8_matmul launches counted, "
            f"{launches}")
    return {"shape": MAIN_SHAPE, "replays": 8, "bitwise": ok,
            "launches_counted": launches}


def phase_graphs(torch, mt, kfa, k8, io_path):
    """Captured against eager in one process (MXTPU_CUDA_GRAPHS), for
    ResNet-50 f32 Adam, ResNet-50 bf16 SGD, the bucketed LSTM and the int8
    Predictor; the per-step values, Dropout's masks, a stale static buffer
    and precompile."""
    from mxnet_tpu_torch.utils import compile as tcm

    mt.set_matmul_precision("highest")
    out = {"phase": "graphs", "steps": GRAPH_STEPS}
    launches = {n: 0 for n in port_kernels()}

    def add(got):
        for n, c in got.items():
            launches[n] += c

    # 1. ResNet-50, batch 32, f32 "highest", fused Adam (phase train's)
    net, args, aux, batch_x, batch_y = resnet50_case()
    X = np.ascontiguousarray(np.broadcast_to(
        batch_x, (GRAPH_STEPS,) + batch_x.shape).reshape((-1,) + IMAGE))
    Y = np.tile(batch_y, GRAPH_STEPS)
    dev = {"data": torch.from_numpy(batch_x).cuda(),
           "softmax_label": torch.from_numpy(batch_y).cuda()}
    rows, gaps, _ = resnet_ab(
        torch, mt, tcm, net, args, aux,
        lambda: mt.io.NDArrayIter(X, Y, batch_size=BATCH), dev, GRAPH_STEPS,
        "resnet50 f32 adam", plants={"no_update": planted_no_update(mt),
                                     "baked_values": planted_baked_values()},
        optimizer="adam", fused=True, learning_rate=LEARNING_RATE)
    require(rows["captured"]["launches"]["fused_adam"] == GRAPH_STEPS,
            "graphs: fused_adam once a step, counted by replay: "
            f"{rows['captured']['launches']}")
    add(rows["captured"]["launches"])
    out["resnet50_f32_adam"] = {**rows, **gaps}
    emit({"phase": "graphs", "resnet50_f32_adam": out["resnet50_f32_adam"]})
    out["fused_adam_replay"] = adam_replay_check(torch, kfa, tcm)

    # 2. ResNet-50 bf16, SGD momentum, one cached batch (io_fit's)
    net, args, aux = xavier_resnet50(torch, mt)
    first = next(iter(io_iter(mt, io_path)))
    dev = {"data": first.data[0].cuda(), "softmax_label": first.label[0].cuda()}
    rows, gaps, _ = resnet_ab(
        torch, mt, tcm, net, args, aux,
        lambda: cached_batches(mt, first, GRAPH_STEPS), dev, GRAPH_STEPS,
        "resnet50 bf16 sgd", optimizer="sgd", learning_rate=IO_LR,
        momentum=IO_MOMENTUM, compute_dtype=torch.bfloat16)
    add(rows["captured"]["launches"])
    out["resnet50_bf16_sgd"] = {**rows, **gaps}
    emit({"phase": "graphs", "resnet50_bf16_sgd": out["resnet50_bf16_sgd"]})

    # a stale static buffer: caught at every replay after the capture
    set_graphs(True)
    _, stale = io_fit(torch, mt, net, args, aux,
                      io_iter(mt, io_path, num_parts=4), 4, stale=True)
    require(stale["digest_mismatches"] == list(range(2, stale["steps"])),
            "graphs: the planted stale static buffer is caught at every "
            f"replay after the capture: {stale['digest_mismatches']}")
    out["planted_stale_buffer"] = {"steps": stale["steps"],
                                   "mismatched_steps":
                                   stale["digest_mismatches"]}

    # 3. the PTB-width bucketed LSTM through BucketingFeedForward
    out["lstm_bucketing"] = graphs_lstm(torch, mt, tcm, add)

    # 4. the int8 Predictor, batch 32
    out["int8_predictor"] = graphs_predictor(torch, mt, tcm, k8, add)
    out["int8_matmul_replay"] = int8_replay_check(torch, k8, tcm)

    # 5. Dropout's masks (AlexNet, bf16, lr 0: the outputs move with the
    # masks only)
    out["dropout"] = graphs_dropout(torch, mt)

    # 6. training captured through an Executor's pair and Module.fit
    out["executor_pair"] = graphs_executor(torch, mt, tcm)
    emit({"phase": "graphs", "executor_pair": out["executor_pair"]})
    out["module_fit"] = graphs_module(torch, mt, tcm)
    set_graphs(True)
    emit({**out, "launches": launches})
    return launches


def lstm_model(mt, captured, **kw):
    set_graphs(captured)
    return mt.bucketing.BucketingFeedForward(
        lstm_sym_gen(mt), default_bucket_key=LSTM_BUCKETS[-1],
        ctx=mt.gpu(0), num_epoch=1, optimizer="sgd",
        arg_params=lstm_args(mt), **kw)


def lstm_iter(mt):
    return mt.bucketing.BucketSentenceIter(
        lstm_sentences(LSTM_GRAPH_SENTENCES), buckets=LSTM_BUCKETS,
        batch_size=LSTM_BATCH, init_states=lstm_states(), seed=SEED)


def graphs_lstm(torch, mt, tcm, add):
    """The bucketed LSTM: precompiled then fit, fit capturing as it goes,
    and eager, bitwise; a FactorScheduler moves lr mid-epoch. The
    precompiled and eager models then train one more epoch under the
    profiler for the card's idle share."""
    params, rows = {}, {}
    for name, captured, pre in (("precompiled", True, True),
                                ("captured", True, False),
                                ("eager", False, False)):
        sched = mt.lr_scheduler.FactorScheduler(step=8, factor=0.5,
                                                base_lr=LSTM_OPT[
                                                    "learning_rate"])
        model = lstm_model(mt, captured, lr_scheduler=sched)
        pre_row = {}
        if pre:
            tcm.reset_compile_stats()
            t0 = time.perf_counter()
            got = model.precompile(data=lstm_iter(mt))
            pre_row = {"programs": got["programs"],
                       "precompile_s": time.perf_counter() - t0,
                       **graph_stats(tcm)}
        tcm.reset_compile_stats()
        reset_launches()
        it = lstm_iter(mt)
        stamps = []

        def stamp(_p):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        tokens = LSTM_BATCH * sum(b for b, _ in it._plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(it, batch_end_callback=stamp)
        total = stamps[-1] - t0
        n = len(stamps)
        if captured:
            add(read_launches())
        rows[name] = {"steps": n, "epoch_s": total,
                      "step_ms_mean": total * 1e3 / n,
                      "tokens_per_s": tokens / total,
                      "precompile": pre_row, **graph_stats(tcm)}
        params[name] = dict(model.arg_params)
        if name != "captured":
            # one more epoch under the profiler: the card's idle share
            rows[name].update(card_report(
                torch, lambda: model.fit(lstm_iter(mt)), 1, "epoch"))
        del model
        torch.cuda.empty_cache()
    same = all(torch.equal(params["precompiled"][k], params[o][k])
               for o in ("captured", "eager") for k in params["eager"])
    require(same, "graphs lstm: precompiled, captured and eager fits end "
            "bitwise equal (lr halved every 8 steps)")
    require(rows["precompiled"]["captures"] == 0
            and rows["precompiled"]["precompile"]["captures"]
            == rows["precompiled"]["precompile"]["programs"]
            == len(LSTM_BUCKETS),
            f"graphs lstm: precompile captured every bucket and the fit "
            f"after it none: {rows['precompiled']}")
    return {**rows, "bitwise": same}


def graphs_predictor(torch, mt, tcm, k8, add):
    """Request latency of the int8 Predictor, replayed and eager, and the
    card's idle share over 4 more requests; the logits bitwise and
    int8_matmul counted once a request."""
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.models import resnet50

    net = resnet50(num_classes=1000)
    shape = (BATCH,) + IMAGE
    args, aux = random_params(net, SEED, data=shape)
    image = np.random.default_rng(SEED + 1).standard_normal(shape, np.float32)
    rows, logits = {}, {}
    for name, captured in (("captured", True), ("eager", False)):
        set_graphs(captured)
        tcm.reset_compile_stats()
        pred = mt.Predictor(net, args, aux, ctx=mt.gpu(0), quantize="int8")
        before = k8.int8_matmul.launches
        got, ms = [], []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            got.append(pred.forward(data=image).get_output(0))
            ms.append((time.perf_counter() - t0) * 1e3)
        n = k8.int8_matmul.launches - before
        if captured:
            add({"int8_matmul": n})
        rep = card_report(
            torch, lambda: pred.forward(data=image).get_output(0), 4,
            "request")
        rows[name] = {**rep,
                      "requests": REQUESTS,
                      "latency_ms_median": statistics.median(ms[2:]),
                      "images_per_s": BATCH * 1e3 / statistics.median(ms[2:]),
                      "int8_matmul_launches": n, **graph_stats(tcm)}
        logits[name] = got
        require(n == REQUESTS, f"graphs predictor ({name}): int8_matmul "
                f"once a request: {n} in {REQUESTS}")
        del pred
        torch.cuda.empty_cache()
    same = all(np.array_equal(a, b)
               for a, b in zip(logits["captured"], logits["eager"]))
    require(same, "graphs predictor: replayed logits bitwise the eager ones")
    return {**rows, "bitwise": same}


def graphs_dropout(torch, mt, remat=None):
    """AlexNet (zoo) with Dropout, bf16, 4 steps at lr 0 (under the remat
    pattern ``remat`` when given): each step's outputs captured and eager
    bitwise, and two replays' differ."""
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.models import alexnet

    net = alexnet(num_classes=1000)
    shape = (BATCH,) + IMAGE
    args, aux = random_params(net, SEED, data=shape)
    rng = np.random.default_rng(SEED + 7)
    x = rng.standard_normal(shape, np.float32)
    y = rng.integers(0, 1000, BATCH).astype(np.float32)
    steps = 4
    outs = {}
    set_remat(remat)
    for name, captured in (("captured", True), ("eager", False)):
        set_graphs(captured)
        mt.random.seed(SEED)
        seen = []

        class Keep(mt.metric.EvalMetric):
            def update(self, labels, preds):
                seen.append(preds[0].float().cpu())

        model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1,
                               optimizer="sgd", learning_rate=0.0,
                               arg_params=args, aux_params=aux,
                               compute_dtype=torch.bfloat16)
        model.fit(mt.io.NDArrayIter(np.concatenate([x] * steps),
                                    np.tile(y, steps), batch_size=BATCH),
                  eval_metric=Keep("keep"))
        outs[name] = seen
        del model
        torch.cuda.empty_cache()
    set_remat(None)
    set_graphs(True)
    same = all(torch.equal(a, b)
               for a, b in zip(outs["captured"], outs["eager"]))
    differ = not torch.equal(outs["captured"][2], outs["captured"][3])
    require(same, "graphs dropout: the replayed steps' outputs (masks) are "
            "bitwise the eager steps'")
    require(differ, "graphs dropout: two replays draw different masks")
    return {"steps": steps, "bitwise_eager": same,
            "replays_differ": differ}


class Killed(Exception):
    pass


def killer(after):
    """A batch callback that raises after ``after`` steps."""
    seen = [0]

    def cb(_p):
        seen[0] += 1
        if seen[0] == after:
            raise Killed()
    return cb


def phase_ckpt(torch, mt, kfa, io_path):
    """Sharded checkpoints at ResNet-50's 161 leaves: save, load, snapshot
    and writer times on phase train's fused-Adam state; a fit killed after
    step 5 and resumed against the uninterrupted fit (ResNet-50 bf16 with
    fused Adam on one cached batch, within twice the spread of two
    uninterrupted fits, and the LSTM, bitwise); a corrupted newest step
    skipped; a planted resume that rebinds the parameters instead of
    copying into the captured buffers. The launches are those of the
    resumed fit: fused_adam once for each step after the resumed one."""
    import os
    import shutil

    from mxnet_tpu_torch import model as model_mod
    from mxnet_tpu_torch.resilience import ckpt_async
    from mxnet_tpu_torch.utils import checkpoint as tck
    from mxnet_tpu_torch.utils import compile as tcm

    mt.set_matmul_precision("highest")
    set_graphs(True)
    root = os.path.join(IO_DIR, "..", "ckpt")
    shutil.rmtree(root, ignore_errors=True)
    net, args, aux, batch_x, batch_y = resnet50_case()
    steps = CKPT_STEPS
    X = np.ascontiguousarray(np.broadcast_to(
        batch_x, (steps,) + batch_x.shape).reshape((-1,) + IMAGE))
    Y = np.tile(batch_y, steps)
    kw = dict(ctx=mt.gpu(0), num_epoch=1, optimizer="adam", fused=True,
              learning_rate=LEARNING_RATE, arg_params=args, aux_params=aux)
    # the times, on a fitted state (161 leaves); the fit writes no
    # checkpoint of its own
    whole = mt.FeedForward(net, **kw)
    whole.fit(mt.io.NDArrayIter(X, Y, batch_size=BATCH))
    state = whole._train_state
    leaves = model_mod.opt_leaves(state.opt_state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tck.save_sharded(os.path.join(root, "timed"), 1, state.params,
                     aux=state.aux, opt_state=leaves, symbol=net)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tck.load_sharded(os.path.join(root, "timed"), 1)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    snap = ckpt_async.capture_snapshot(2, state.params, aux=state.aux,
                                       opt_state=leaves)
    stall_ms = (time.perf_counter() - t0) * 1e3
    writer = ckpt_async.AsyncCheckpointWriter(os.path.join(root, "timed"),
                                              keep_last_k=0)
    writer.submit(snap)
    writer.close()
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                 os.walk(os.path.join(root, "timed", "2")) for f in fs)
    del whole, state, leaves, snap
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(root, "timed"))

    # the resume gates: io_fit's bf16 step on one cached batch (whose
    # cuDNN kernels ran bitwise from run to run in phase graphs) with
    # fused Adam, so the resume restores the moments the kernel reads
    net, args, aux = xavier_resnet50(torch, mt)
    first = next(iter(io_iter(mt, io_path)))
    kw = dict(ctx=mt.gpu(0), num_epoch=1, optimizer="adam", fused=True,
              learning_rate=LEARNING_RATE, arg_params=args, aux_params=aux,
              compute_dtype=torch.bfloat16)

    def fit(model, d, kill=None):
        try:
            model.fit(cached_batches(mt, first, steps),
                      sharded_checkpoint_dir=d, checkpoint_every_n_steps=2,
                      batch_end_callback=kill)
        except Killed:
            return False
        return True

    wholes = []
    for name in ("whole", "whole_again"):
        whole = mt.FeedForward(net, **kw)
        fit(whole, os.path.join(root, name))
        wholes.append(dict(whole.arg_params))
        del whole
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(root, name))
    ref = wholes[0]
    spread = max_gap(torch, wholes[1], ref)
    bound = 2 * spread

    # killed after step 5 (snapshots at 2 and 4 durable), resumed
    d = os.path.join(root, "killed")
    victim = mt.FeedForward(net, **kw)
    require(not fit(victim, d, killer(5)), "ckpt: the fit was killed")
    require(tck.latest_step(d) == 4, f"ckpt: newest step {tck.latest_step(d)}")
    tcm.reset_compile_stats()
    # the main path: every count is read around the resumed fit
    reset_launches()
    require(fit(victim, d), "ckpt: the resumed fit ran to its end")
    launches = read_launches()
    resumed = graph_stats(tcm)
    gap = max_gap(torch, victim.arg_params, ref)
    require(victim.begin_epoch == 0 and resumed["captures"] == 0,
            f"ckpt: resumed into the same captured steps: {resumed}")
    require(launches["fused_adam"] == steps - 4,
            f"ckpt: fused_adam once a resumed step, counted by replay: "
            f"{launches}")
    require(gap <= bound, f"ckpt: resumed ResNet-50 {gap} from the "
            f"uninterrupted fit, beyond twice the spread of two "
            f"uninterrupted fits {spread}")
    # the newest step corrupted: skipped
    newest = tck.latest_step(d)
    shard = sorted(os.path.join(dp, f) for dp, _, fs in
                   os.walk(os.path.join(d, str(newest), "state"))
                   for f in fs)[0]
    with open(shard, "r+b") as f:
        f.seek(os.path.getsize(shard) // 2)
        f.write(b"\xde\xad\xbe\xef")
    skipped_to = tck.latest_step(d)
    require(skipped_to is not None and skipped_to < newest,
            f"ckpt: corrupted newest step {newest} skipped: {skipped_to}")
    del victim
    torch.cuda.empty_cache()
    shutil.rmtree(d)

    # the planted fault: a resume that rebinds the parameter tensors
    d = os.path.join(root, "rebind")
    victim = mt.FeedForward(net, **kw)
    fit(victim, d, killer(5))
    real = model_mod._TrainState.load

    def rebinding(self, params, aux, opt_leaves_=None):
        real(self, params, aux, opt_leaves_)
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in self.params.items()}

    model_mod._TrainState.load = rebinding
    try:
        fit(victim, d)
    finally:
        model_mod._TrainState.load = real
    planted = max_gap(torch, victim.arg_params, ref)
    require(planted > bound, "ckpt: the planted rebinding resume is "
            f"caught: {planted} against {bound}")
    del victim
    torch.cuda.empty_cache()

    # the LSTM, killed and resumed, bitwise
    lstm = {}
    for name, kill in (("whole", None), ("killed", 5)):
        model = lstm_model(mt, True, learning_rate=LSTM_OPT["learning_rate"])
        dl = os.path.join(root, f"lstm_{name}")

        def go(cb=None):
            try:
                model.fit(lstm_iter(mt), sharded_checkpoint_dir=dl,
                          checkpoint_every_n_steps=2, batch_end_callback=cb)
            except Killed:
                return False
            return True

        if kill:
            require(not go(killer(kill)), "ckpt lstm: killed")
        require(go(), "ckpt lstm: ran to its end")
        lstm[name] = dict(model.arg_params)
        del model
        torch.cuda.empty_cache()
    lstm_same = all(torch.equal(lstm["whole"][k], lstm["killed"][k])
                    for k in lstm["whole"])
    require(lstm_same, "ckpt lstm: the resumed fit is bitwise the "
            "uninterrupted one")
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "ckpt", "leaves": len(args), "state_bytes": nbytes,
          "save_sharded_ms": save_ms, "load_sharded_ms": load_ms,
          "capture_snapshot_stall_ms": stall_ms,
          "writer_background_ms": writer.write_seconds * 1e3,
          "resnet50_resume": {"optimizer": "adam", "fused": True,
                              "compute_dtype": "bfloat16", "every": 2,
                              "killed_after": 5, "resumed_from": 4,
                              "max_abs_vs_whole": gap,
                              "whole_vs_whole": spread, "bound": bound,
                              **resumed},
          "corrupted_newest": {"step": newest, "latest_step": skipped_to},
          "planted_rebinding_max_abs": planted,
          "lstm_resume_bitwise": lstm_same, "launches": launches})
    return launches


# -- slice 16 -----------------------------------------------------------------

def ctx_rows(torch, comm, size, mode, world):
    """The ``(world, Lp)`` f32 rows of one in-process exchange case, on the
    host: each replica's padded flat gradient with its residual added,
    seeded by the case so that every process draws the same rows."""
    spec = comm.CompressionSpec(mode)
    lp = comm.padded_flat_size(size, spec, world)
    gen = torch.Generator().manual_seed(SEED + 30 + world + size % 997
                                        + (7 if mode == "twobit" else 0))
    return spec, torch.randn((world, lp), generator=gen) * 1e-3


def wall_ms(torch, fn, reps, barrier=None):
    """Median wall-clock ms of ``fn`` (the host's part and the card's),
    synchronized before and after each call; the first call is a warm-up."""
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ctx_gloo_body(torch, rank, world):
    """The two-rank gloo exchange of the rows the in-process exchange takes
    (each rank its own row, staged through pinned host buffers): digests of
    each case's reduced vector and residual, and its time."""
    import torch.distributed as dist

    from mxnet_tpu_torch import comm

    kernels = comm.CommKernelConfig()
    out = {}
    for name, size in CTX_SIZES.items():
        for mode in DP_MODES:
            spec, rows = ctx_rows(torch, comm, size, mode, world)
            flat = rows[rank].cuda()
            res = comm.error_feedback_exchange(flat, spec, axis_size=world,
                                               kernels=kernels)
            torch.cuda.synchronize()
            out[f"{name}/{mode}"] = {
                "digest": digest_arrays(torch, {"out": res[0],
                                                "resid": res[1]}),
                "ms": wall_ms(torch, lambda: comm.error_feedback_exchange(
                    flat, spec, axis_size=world, kernels=kernels),
                    CTX_REPS, dist.barrier)}
    return out


@contextlib.contextmanager
def plain_on_card(ck):
    """The comm kernels' plain versions on CUDA tensors (the reference the
    in-process exchange is held to), for the duration of a ``with``."""
    real = ck.use_kernel
    ck.use_kernel = lambda *tensors: False
    try:
        yield
    finally:
        ck.use_kernel = real


def ctx_alias_fit(torch, mt, tcm):
    """``FeedForward(ctx=[gpu(0), gpu(1)])`` on the one card: one replica
    after aliases are removed, captured, and its fit bitwise the
    ``ctx=gpu(0)`` fit."""
    from mxnet_tpu_torch.convert import random_params

    net = mt.models.mlp()
    args = random_params(net, SEED + 31, data=(CTX_FIT_BATCH, 784))[0]
    rng = np.random.default_rng(SEED + 32)
    X = rng.standard_normal((CTX_FIT_STEPS * CTX_FIT_BATCH, 784), np.float32)
    Y = rng.integers(0, 10, len(X)).astype(np.float32)
    set_graphs(True)
    fits = {}
    for name, ctx in (("list", [mt.gpu(0), mt.gpu(1)]), ("one", mt.gpu(0))):
        tcm.reset_compile_stats()
        reset_launches()
        model = mt.FeedForward(net, ctx=ctx, num_epoch=1, optimizer="adam",
                               fused=True, learning_rate=LEARNING_RATE,
                               arg_params=dict(args))
        model.fit(mt.io.NDArrayIter(X, Y, batch_size=CTX_FIT_BATCH,
                                    shuffle=False))
        fits[name] = (model, graph_stats(tcm), read_launches())
    model, stats, launches = fits["list"]
    one = fits["one"][0]
    single = torch.cuda.device_count() == 1
    require(not single or len(model._replicas) == 1,
            f"ctx_list: [gpu(0), gpu(1)] is one device on one card: "
            f"{model._replicas}")
    require(mt.gpu(1).torch_device == torch.device(
        "cuda", 1 % torch.cuda.device_count()), "ctx_list: gpu(1) is card "
        "1 % the cards")
    require(stats["captures"] == 1 and stats["replays"] == CTX_FIT_STEPS - 1
            and not stats["eager"], f"ctx_list: the aliased fit is captured "
            f"(one capture, {CTX_FIT_STEPS - 1} replays): {stats}")
    require(launches["fused_adam"] == CTX_FIT_STEPS,
            f"ctx_list: fused_adam once a step by replay: {launches}")
    bitwise = all(torch.equal(model.arg_params[k], one.arg_params[k])
                  for k in args)
    require(bitwise, "ctx_list: the [gpu(0), gpu(1)] fit is bitwise the "
            "gpu(0) fit")
    return {"replicas": len(model._replicas), "steps": CTX_FIT_STEPS,
            "batch": CTX_FIT_BATCH, "bitwise_vs_gpu0": bitwise, **stats,
            "launches": launches}


def phase_ctx_list(torch, mt, comm, ck):
    """A ctx list in one process on the card: the replicas' exchange
    (2 and 4 replicas, ResNet-50's gradient and one 4 MB bucket, int8 and
    twobit, error feedback) against the plain versions and the two gloo
    ranks, and an aliased ctx list's fit. Returns the kernels' launches on
    the exchange path."""
    from mxnet_tpu_torch.utils import compile as tcm

    gloo = run_ranks(torch, ctx_gloo_body, 2, CTX_TIMEOUT_S, "ctx_list")
    kernels = comm.CommKernelConfig()
    card = torch.device("cuda", 0)
    launches = {n: 0 for n in port_kernels()}
    cases = []
    for world in CTX_REPLICAS:
        group = comm.ReplicaGroup([card] * world)
        for name, size in CTX_SIZES.items():
            for mode in DP_MODES:
                spec, host = ctx_rows(torch, comm, size, mode, world)
                flats = [host[r].to(card) for r in range(world)]
                del host
                torch.cuda.synchronize()
                # the main path: each count set to 0 just before the
                # exchange and read just after it
                reset_launches()
                outs, resid = comm.error_feedback_exchange(
                    flats, spec, group=group, kernels=kernels)
                got = read_launches()
                torch.cuda.synchronize()
                want = {k: v * world for k, v in DP_LAUNCHES[mode].items()
                        if k != "fused_adam"}
                require({k: c for k, c in got.items() if c} == want,
                        f"ctx_list {world} x {name} {mode}: launches {got}, "
                        f"expected {want}")
                for k, c in got.items():
                    launches[k] += c
                digests = [digest_arrays(torch, {"out": o, "resid": r})
                           for o, r in zip(outs, resid)]
                del outs, resid
                with plain_on_card(ck):
                    p_outs, p_resid = comm.error_feedback_exchange(
                        flats, spec, group=group, kernels=kernels)
                plain = [digest_arrays(torch, {"out": o, "resid": r})
                         for o, r in zip(p_outs, p_resid)]
                del p_outs, p_resid
                require(digests == plain,
                        f"ctx_list {world} x {name} {mode}: the kernels' "
                        "exchange is bitwise its plain versions'")
                row = {"replicas": world, "case": name, "elements": size,
                       "mode": mode, "launches": got,
                       "bitwise_plain": True,
                       "in_process_ms": wall_ms(
                           torch, lambda: comm.error_feedback_exchange(
                               flats, spec, group=group, kernels=kernels),
                           CTX_REPS)}
                if world == 2:
                    ranks = [g[f"{name}/{mode}"] for g in gloo]
                    require(digests == [r["digest"] for r in ranks],
                            f"ctx_list 2 x {name} {mode}: the replicas' "
                            "results and residuals are bitwise the two gloo "
                            "ranks'")
                    row.update(bitwise_gloo=True,
                               gloo_ms=[r["ms"] for r in ranks])
                cases.append(row)
                emit({"phase": "ctx_list", **row})
                del flats
                torch.cuda.empty_cache()
    alias = ctx_alias_fit(torch, mt, tcm)
    emit({"phase": "ctx_list", "aliased_fit": alias})
    return launches


def lm_profile(torch, step_fn):
    """Device time and idle share of 3 more steps (torch.profiler)."""
    step_fn()
    torch.cuda.synchronize()
    return card_report(torch, step_fn, 3, "step")


def lm_graph_run(torch, mt, topt, tcm, model, params0, batches, captured,
                 plant=None):
    """LM_GRAPH_STEPS steps of ``make_train_step`` from ``params0`` over
    the alternating ``batches``, captured or eager (``MXTPU_CUDA_GRAPHS``);
    ``plant="stale_tokens"`` rebinds the captured program's token buffer
    after its capture (the graph goes on reading the old one). Returns the
    parameters, losses, step ms, launches, graph counters and a profile."""
    set_graphs(captured)
    opt = topt.create("adam", learning_rate=LEARNING_RATE, fused=True)
    params = {k: v.clone() for k, v in params0.items()}
    state = opt.init_state_tree(params)
    step = model.make_train_step(None, optimizer=opt)
    tcm.reset_compile_stats()
    torch.cuda.synchronize()
    # the main path: each count set to 0 just before and read just after
    reset_launches()
    losses, ms = [], []
    for i in range(LM_GRAPH_STEPS):
        if plant == "stale_tokens" and i == 2:
            prog = next(iter(step.programs.values()))
            prog["held_tokens"] = prog["tokens"]
            prog["tokens"] = torch.empty_like(prog["tokens"])
        tok, tgt = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tok, tgt)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = read_launches()
    stats = graph_stats(tcm)
    row = {"losses": losses, "step_ms": ms,
           "step_ms_median": statistics.median(ms[2:]),
           "launches": launches, **stats}
    if plant is None:
        carry = [params, state]

        def again():
            carry[0], carry[1], _ = step(*carry, *batches[0])

        row.update(lm_profile(torch, again))
    return params, row


def phase_lm_graphs(torch, mt, topt, params0):
    """The full-width LM's make_train_step captured against eager in one
    process, with a planted stale token buffer. Returns the launches of
    the captured run (counted by replay)."""
    from mxnet_tpu_torch.models import TransformerLM, transformer_lm_config
    from mxnet_tpu_torch.utils import compile as tcm

    cfg = transformer_lm_config()
    model = TransformerLM(cfg)
    rng = np.random.default_rng(SEED + 40)
    batches = [tuple(torch.from_numpy(t).cuda() for t in lm_tokens(
        rng, LM_BATCH, LM_SEQ, cfg["vocab_size"])) for _ in range(2)]
    runs, params = {}, {}
    for name, captured, plant in (("captured", True, None),
                                  ("eager", False, None),
                                  ("eager_again", False, None),
                                  ("planted_stale_tokens", True,
                                   "stale_tokens")):
        params[name], runs[name] = lm_graph_run(
            torch, mt, topt, tcm, model, params0, batches, captured, plant)
        torch.cuda.empty_cache()
    set_graphs(True)
    spread = max_gap(torch, params["eager"], params["eager_again"])
    gap = max_gap(torch, params["captured"], params["eager"])
    loss_spread = max(abs(a - b) for a, b in zip(
        runs["eager"]["losses"], runs["eager_again"]["losses"]))
    loss_gap = max(abs(a - b) for a, b in zip(
        runs["captured"]["losses"], runs["eager"]["losses"]))
    planted = max(abs(a - b) for a, b in zip(
        runs["planted_stale_tokens"]["losses"], runs["eager"]["losses"]))
    bitwise = spread == 0.0 and loss_spread == 0.0
    require(gap <= 2 * spread and loss_gap <= 2 * loss_spread,
            f"lm_graphs: captured vs eager parameters {gap} and losses "
            f"{loss_gap}, against twice the eager runs' spread {spread}, "
            f"{loss_spread}" + (" (bitwise)" if bitwise else ""))
    require(planted > 2 * loss_spread,
            f"lm_graphs: the planted stale token buffer reads above the "
            f"bound: {planted} against {2 * loss_spread}")
    per_step = {"flash_fwd": cfg["n_layers"], "flash_bwd_dq": cfg["n_layers"],
                "flash_bwd_dkv": cfg["n_layers"], "fused_adam": 1}
    cap = runs["captured"]
    for n, k in per_step.items():
        require(cap["launches"][n] == k * LM_GRAPH_STEPS,
                f"lm_graphs: {n} launched {cap['launches'][n]} times in "
                f"{LM_GRAPH_STEPS} captured steps, expected {k} a step")
    require(cap["captures"] == 1 and cap["replays"] == LM_GRAPH_STEPS - 1
            and not cap["eager"], f"lm_graphs: one capture and "
            f"{LM_GRAPH_STEPS - 1} replays: {cap}")
    require(runs["eager"]["eager"] == {"MXTPU_CUDA_GRAPHS=0": 1},
            f"lm_graphs: the eager run counts its reason: {runs['eager']}")
    require(all(np.isfinite(r["losses"]).all() for r in runs.values()),
            "lm_graphs: finite losses")
    emit({"phase": "lm_graphs", "batch": LM_BATCH, "seq": LM_SEQ,
          "steps": LM_GRAPH_STEPS, "optimizer": "adam", "fused": True,
          "batches": len(batches), "captured": cap, "eager": runs["eager"],
          "eager_again": runs["eager_again"],
          "captured_vs_eager_params": gap, "eager_vs_eager_params": spread,
          "captured_vs_eager_loss": loss_gap,
          "eager_vs_eager_loss": loss_spread, "bitwise": bitwise,
          "planted_stale_tokens_loss_gap": planted,
          "tokens_per_s_captured": LM_BATCH * LM_SEQ * 1e3
          / cap["step_ms_median"],
          "tokens_per_s_eager": LM_BATCH * LM_SEQ * 1e3
          / runs["eager"]["step_ms_median"]})
    return cap["launches"]


def spread_gate(torch, what, runs):
    """Captured within twice the eager runs' spread (bitwise where the
    eager run repeats itself bitwise), over each run's dict of tensors."""
    spread = max_gap(torch, runs["eager"], runs["eager_again"])
    gap = max_gap(torch, runs["captured"], runs["eager"])
    require(gap <= 2 * spread, f"graphs {what}: captured vs eager {gap}, "
            f"beyond twice the eager runs' spread {spread}")
    return {"captured_vs_eager": gap, "eager_vs_eager": spread,
            "bitwise": gap == 0.0}


def graphs_executor(torch, mt, tcm):
    """A ResNet-50 Executor's training pair: ``precompile(is_train=True)``
    then 3 replayed forward/backward steps on new data, against eager."""
    net, args, aux, batch_x, batch_y = resnet50_case()
    xs = [batch_x * np.float32(1 + 0.25 * i) for i in range(EXE_STEPS)]
    runs, rows = {}, {}
    for name, captured in (("captured", True), ("eager", False),
                           ("eager_again", False)):
        set_graphs(captured)
        tcm.reset_compile_stats()
        exe = net.simple_bind(mt.gpu(0), grad_req={k: "write" for k in args},
                              data=(BATCH,) + IMAGE, softmax_label=(BATCH,))
        exe.copy_params_from({k: torch.from_numpy(v) for k, v in args.items()},
                             {k: torch.from_numpy(v) for k, v in aux.items()})
        seconds = exe.precompile(is_train=True)
        ms = []
        for x in xs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = exe.forward(is_train=True, data=x, softmax_label=batch_y)
            exe.backward()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[name] = {**{f"grad:{k}": v.clone() for k, v in
                         exe.grad_dict.items()},
                      **{f"aux:{k}": v.clone() for k, v in
                         exe.aux_dict.items()}, "out": outs[0].clone()}
        rows[name] = {"precompile_s": seconds, "step_ms": ms,
                      **graph_stats(tcm)}
        del exe
        torch.cuda.empty_cache()
    set_graphs(True)
    gate = spread_gate(torch, "executor pair", runs)
    cap = rows["captured"]
    require(cap["captures"] == 2 and cap["replays"] == 2 * EXE_STEPS
            and cap["precompile_s"] > 0.0, "graphs: the executor's pair "
            f"captured once (two graphs) and replayed each step: {cap}")
    require(rows["eager"]["precompile_s"] == 0.0
            and rows["eager"]["eager"] == {"MXTPU_CUDA_GRAPHS=0": 1},
            f"graphs: the eager executor counts its reason: {rows['eager']}")
    return {**rows, **gate, "steps": EXE_STEPS}


def graphs_module(torch, mt, tcm):
    """``Module.fit`` of an MLP (batch 64, SGD momentum) captured against
    eager: the pair captured before the first step, every step a replay."""
    from mxnet_tpu_torch.convert import random_params

    net = mt.models.mlp()
    args = random_params(net, SEED + 33, data=(CTX_FIT_BATCH, 784))[0]
    rng = np.random.default_rng(SEED + 34)
    X = rng.standard_normal((MODULE_STEPS * CTX_FIT_BATCH, 784), np.float32)
    Y = rng.integers(0, 10, len(X)).astype(np.float32)
    runs, rows = {}, {}
    for name, captured in (("captured", True), ("eager", False),
                           ("eager_again", False)):
        set_graphs(captured)
        tcm.reset_compile_stats()
        mod = mt.mod.Module(net, context=mt.gpu(0))
        mod.bind([("data", (CTX_FIT_BATCH, 784))],
                 [("softmax_label", (CTX_FIT_BATCH,))])
        mod.init_params(arg_params={k: torch.from_numpy(v)
                                    for k, v in args.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=CTX_FIT_BATCH,
                                  shuffle=False), num_epoch=1,
                optimizer="sgd", optimizer_params={"learning_rate": 0.05,
                                                   "momentum": 0.9})
        torch.cuda.synchronize()
        runs[name] = dict(mod.get_params()[0])
        rows[name] = {"fit_s": time.perf_counter() - t0, **graph_stats(tcm)}
    set_graphs(True)
    gate = spread_gate(torch, "Module.fit", runs)
    cap = rows["captured"]
    require(cap["captures"] == 2 and cap["replays"] == 2 * MODULE_STEPS,
            f"graphs: Module.fit replays its pair every step: {cap}")
    return {**rows, **gate, "steps": MODULE_STEPS}

# -- slice 17: observability -------------------------------------------------

TELEMETRY_STEPS = 20
TELEMETRY_WINDOW = dict(steps=4, warmup=4)
# the health step read apart: snapshots after steps 10 and 11
TELEMETRY_HEALTH_STEP = 11
# the timed steps (the card drained before the first and after the last)
TELEMETRY_TIMED = (13, 19)
TELEMETRY_HEALTH_BOUND = 1e-5
TELEMETRY_FLOP_BOUND = 1e-2
TELEMETRY_DIR = "build/chip_smoke/telemetry"
TELEMETRY_PREDICT_BATCHES = 3


def analytic_contraction_flops(net, batch):
    """ResNet-50's contraction FLOPs of one training step from its shapes:
    for each convolution the forward, the input gradient (not for the
    first, whose input is the data) and the weight gradient, each as
    2 x the MACs of the convolution the JAX package's transpose makes
    (mxnet_tpu/analysis/jaxpr_audit.py:94-123: output elements x 2 x the
    kernel's elements per output feature), and the same three for the FC
    layer's product."""
    internals = net.get_internals()
    shape = (batch,) + IMAGE
    _, out_shapes, _ = internals.infer_shape(data=shape)
    out_of = dict(zip(internals.list_outputs(), out_shapes))
    arg_shapes, _, _ = net.infer_shape(data=shape)
    arg_of = dict(zip(net.list_arguments(), arg_shapes))
    convs = fcs = 0
    total = 0
    for node in net._topo():
        if node.is_variable:
            continue
        op = node.op.name
        if op not in ("Convolution", "FullyConnected"):
            continue
        src, k = node.inputs[0]
        x_shape = arg_of["data"] if src.is_variable else \
            out_of[src.output_names()[k]]
        w = arg_of[f"{node.name}_weight"]
        y = out_of[node.output_names()[0]]
        x_n, w_n, y_n = (int(np.prod(v)) for v in (x_shape, w, y))
        if op == "Convolution":
            convs += 1
            fwd = y_n * 2 * (w_n // w[0])
            dw = w_n * 2 * (y_n // w[0])
            dx = 0 if src.is_variable else x_n * 2 * (w_n // w[1])
        else:
            fcs += 1
            fwd = dw = dx = 2 * batch * w[0] * w[1]
        total += fwd + dw + dx
    require(convs == 53 and fcs == 1, f"ResNet-50 has 53 convolutions and "
            f"one FC layer ({convs}, {fcs})")
    return total


def telemetry_fit(torch, mt, net, args, aux, X, Y, on, hook):
    """One fit of ResNet-50 (bf16 compute, fused Adam, captured steps) of
    TELEMETRY_STEPS steps, with telemetry, health and the profile window
    on (``on``: the JSONL path) or off; ``hook(i, model)`` after each
    step."""
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="adam",
                           fused=True, learning_rate=LEARNING_RATE,
                           compute_dtype=torch.bfloat16,
                           arg_params=args, aux_params=aux)
    count = [0]

    def step_hook(batch, arrays):
        hook(count[0], model)
        count[0] += 1

    model._step_hook = step_hook
    kw = {}
    if on is not None:
        kw = dict(telemetry=mt.telemetry.TelemetryConfig(jsonl=on),
                  health=True,
                  profile=mt.telemetry.ProfileConfig(
                      log_dir=f"{TELEMETRY_DIR}/profile",
                      **TELEMETRY_WINDOW))
    model.fit(mt.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=False), **kw)
    require(count[0] == TELEMETRY_STEPS, f"{TELEMETRY_STEPS} steps ran")
    return model


def health_f64(torch, groups, pre, post, grads):
    """The four health vectors recomputed in f64 on the card from the
    step's snapshots."""
    out = {k: [] for k in ("grad_norm", "weight_norm", "update_ratio",
                           "nonfinite")}
    for names in groups.values():
        g = sum(float((grads[n].double() ** 2).sum()) for n in names)
        w = sum(float((pre[n].double() ** 2).sum()) for n in names)
        d = sum(float(((post[n].double() - pre[n].double()) ** 2).sum())
                for n in names)
        out["grad_norm"].append(g ** 0.5)
        out["weight_norm"].append(w ** 0.5)
        out["update_ratio"].append(d ** 0.5 / (w ** 0.5 + 1e-12))
        out["nonfinite"].append(sum(int((~torch.isfinite(grads[n])).sum())
                                    for n in names))
    return {k: np.array(v) for k, v in out.items()}


def lock_pair_ns(lockwatch, armed, n=200_000):
    """Nanoseconds of one acquire/release pair of a named lock."""
    was = lockwatch.enabled()
    if armed:
        lockwatch.enable()
    else:
        lockwatch.disable()
    lock = lockwatch.named_lock("chip_smoke.bench")
    t0 = time.perf_counter()
    for _ in range(n):
        lock.acquire()
        lock.release()
    ns = (time.perf_counter() - t0) / n * 1e9
    if was:
        lockwatch.enable()
    return ns


def phase_telemetry(torch, mt):
    """Full-width ResNet-50 (batch 32, bf16 compute_dtype, fused Adam,
    captured steps) through ``fit(telemetry=, health=True, profile=)``
    with the lock watchdog armed and the flight recorder and run ledger
    writing into a directory of their own, then one ``predict(telemetry=,
    profile=)``, and the same fit with all of it off; the gates of the
    observability layer (module docstring, item 5o)."""
    import glob
    import gzip
    import os
    import shutil
    import tempfile

    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.analysis import lockwatch
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.utils import compile as tcm

    os.makedirs("build/chip_smoke", exist_ok=True)
    shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    os.makedirs(TELEMETRY_DIR)
    root = tempfile.mkdtemp(dir=TELEMETRY_DIR)
    flight_dir, ledger_dir = f"{root}/flight", f"{root}/ledger"
    set_graphs(True)
    net, args, aux, batch_x, batch_y = resnet50_case()
    rng = np.random.default_rng(SEED + 17)
    X = rng.standard_normal((TELEMETRY_STEPS * BATCH,) + IMAGE, np.float32)
    X[:BATCH] = batch_x
    Y = rng.integers(0, 1000, TELEMETRY_STEPS * BATCH).astype(np.float32)
    watermark = {}

    def timing_hook(times):
        def hook(i, model):
            if i in TELEMETRY_TIMED:
                torch.cuda.synchronize()
                times[i] = time.perf_counter()
        return hook

    # the same fit with everything off, first, in this process
    off_times = {}
    tt.reset()
    model = telemetry_fit(torch, mt, net, args, aux, X, Y, None,
                          timing_hook(off_times))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # -- the main path ------------------------------------------------------
    os.environ["MXNET_TPU_FLIGHT_DIR"] = flight_dir
    os.environ["MXNET_TPU_LEDGER_DIR"] = ledger_dir
    os.environ["MXNET_TPU_LOCKWATCH"] = "1"
    tt.reset()
    tt.flight.reset()
    lockwatch.enable()
    lockwatch.reset()
    tcm.reset_compile_stats()
    torch.cuda.reset_peak_memory_stats()
    jsonl = f"{root}/run.jsonl"
    on_times, snaps = {}, {}
    timed = timing_hook(on_times)

    def hook(i, model):
        timed(i, model)
        if i in (TELEMETRY_HEALTH_STEP - 1, TELEMETRY_HEALTH_STEP):
            torch.cuda.synchronize()
            state = model._train_state
            with torch.no_grad():
                snaps[i] = {"params": {k: v.detach().clone()
                                       for k, v in state.params.items()}}
                if i == TELEMETRY_HEALTH_STEP:
                    snaps[i]["grads"] = {k: v.clone()
                                         for k, v in state.grads.items()}
                    snaps[i]["health"] = {
                        k: v.clone() for k, v in state.health.buffers.items()}
                    snaps[i]["groups"] = state.health.groups
        if i == TELEMETRY_STEPS - 1:
            watermark["ledger"] = tt.memory.ledger().stats()

    reset_launches()
    model = telemetry_fit(torch, mt, net, args, aux, X, Y, jsonl, hook)
    launches = read_launches()
    fit_stats = tcm.compile_stats()
    window = TELEMETRY_WINDOW["steps"]
    # -- captured steps stay captured -------------------------------------
    require(fit_stats["eager"] == {"profile window": window},
            f"no eager step outside the profile window "
            f"({fit_stats['eager']})")
    train = {k: v for k, v in fit_stats["per_function"].items()
             if k.startswith("train_step")}
    require(len(train) == 1, f"one training program ({list(train)})")
    (label, counts), = train.items()
    # the counted step and the warm-up run eager, the window eager
    require(counts["replays"] == TELEMETRY_STEPS - window - 2
            and counts["captures"] == 1,
            f"{TELEMETRY_STEPS - window - 2} replays and one capture "
            f"({counts})")
    require(launches["fused_adam"] == TELEMETRY_STEPS,
            f"fused_adam once a step ({launches['fused_adam']})")
    require(all(n == 0 for k, n in launches.items() if k != "fused_adam"),
            f"no other kernel on this path ({launches})")

    # -- health on the card -----------------------------------------------
    snap = snaps[TELEMETRY_HEALTH_STEP]
    groups = snap["groups"]
    want = health_f64(torch, groups,
                      snaps[TELEMETRY_HEALTH_STEP - 1]["params"],
                      snap["params"], snap["grads"])
    health_err = {}
    for k in ("grad_norm", "weight_norm", "update_ratio"):
        got = snap["health"][k].double().cpu().numpy()
        health_err[k] = float(np.max(np.abs(got - want[k]) / want[k]))
        require(health_err[k] < TELEMETRY_HEALTH_BOUND,
                f"health {k} within {TELEMETRY_HEALTH_BOUND} of f64 "
                f"({health_err[k]})")
    got_nf = snap["health"]["nonfinite"].cpu().numpy()
    require(not got_nf.any() and not want["nonfinite"].any(),
            "nonfinite is exactly 0")
    events = tt.hub().events("health")
    require(len(events) == TELEMETRY_STEPS and all(e["finite"]
                                                    for e in events),
            f"one finite health event a step ({len(events)})")
    # planted: one NaN in one leaf's gradient
    names = list(groups)
    victim_layer = "stage3_unit2_br2_conv"
    victim = groups[victim_layer][0]
    planted = dict(snap["grads"])
    planted[victim] = planted[victim].clone()
    planted[victim].view(-1)[123] = float("nan")
    stats = tt.health.device_stats(
        groups, snaps[TELEMETRY_HEALTH_STEP - 1]["params"], planted,
        snap["params"], torch.tensor(1.0, device="cuda"))
    nf = stats["nonfinite"].cpu().numpy()
    require(nf[names.index(victim_layer)] == 1 and nf.sum() == 1,
            f"the planted NaN counted once on {victim_layer}")
    monitor = tt.HealthMonitor().attach()
    try:
        tt.health.observe_device_stats(groups, stats, 0, 99)
        blamed = monitor.blamed_layer()
    finally:
        monitor.detach()
    require(blamed == (victim_layer, "nonfinite"),
            f"HealthMonitor blames {victim_layer} ({blamed})")

    # -- profile ----------------------------------------------------------
    report = model.profile_report
    require(report is not None and report.steps == window,
            "a profile report of the window")
    trace_files = glob.glob(f"{report.log_dir}/*.pt.trace.json.gz")
    require(len(trace_files) == 1, f"one trace file ({trace_files})")
    with gzip.open(trace_files[0], "rt") as f:
        trace_events = json.load(f)["traceEvents"]
    device = [e for e in trace_events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    measured_us = sum(float(e.get("dur", 0.0)) for e in device)
    rows_us = sum(r["us"] for r in report.ops)
    rows_count = sum(r["count"] for r in report.ops)
    require(rows_count == len(device),
            f"every device event in one row ({rows_count} of {len(device)})")
    require(abs(rows_us - measured_us) <= 1e-6 * measured_us
            and abs(report.total_us - measured_us) <= 1e-6 * measured_us,
            f"rows add up to the trace ({rows_us}, {report.total_us}, "
            f"{measured_us} us)")
    adam_rows = [r for r in report.ops if r["op"] == "fused_adam"]
    require(len(adam_rows) == 1 and adam_rows[0]["layer"] == "optimizer"
            and adam_rows[0]["count"] == window,
            f"fused_adam once a window step under optimizer ({adam_rows})")
    spans = model.telemetry.steps()
    require(len(spans) == TELEMETRY_STEPS, "one span a step")
    # an eager window step's device time mostly overlaps its dispatch
    # (the host launches op by op): the spans' device phase reads only the
    # tail, their dispatch + device phases the whole step
    window_device_ms = sum(d for sp in spans[window:2 * window]
                           for n, _, d in sp.phases() if n == "device") * 1e3
    window_step_ms = sum(d for sp in spans[window:2 * window]
                         for n, _, d in sp.phases()
                         if n in ("dispatch", "device")) * 1e3
    replay_device_ms = statistics.median(
        d * 1e3 for sp in spans[2 * window + 1:]
        for n, _, d in sp.phases() if n == "device")

    # -- MFU ----------------------------------------------------------------
    acct = model.mfu
    analytic = analytic_contraction_flops(net, BATCH)
    flop_err = abs(acct.contraction_flops - analytic) / analytic
    require(flop_err < TELEMETRY_FLOP_BOUND,
            f"contraction FLOPs within 1% of the analytic count "
            f"({acct.contraction_flops} vs {analytic})")
    peak = acct.peak_flops
    on_ms = (on_times[TELEMETRY_TIMED[1]] - on_times[TELEMETRY_TIMED[0]]) \
        / (TELEMETRY_TIMED[1] - TELEMETRY_TIMED[0]) * 1e3
    off_ms = (off_times[TELEMETRY_TIMED[1]] - off_times[TELEMETRY_TIMED[0]]) \
        / (TELEMETRY_TIMED[1] - TELEMETRY_TIMED[0]) * 1e3
    mfu_pct = 100.0 * acct.flops_per_step / (off_ms / 1e3) / peak

    # -- predict --------------------------------------------------------------
    n_pred = TELEMETRY_PREDICT_BATCHES * BATCH
    out = model.predict(X[:n_pred], batch_size=BATCH, telemetry=True,
                        profile=mt.telemetry.ProfileConfig(steps=1, warmup=1))
    require(out.shape == (n_pred, 1000) and np.isfinite(out).all(),
            "predict's outputs")
    pred_report = model.profile_report
    require(pred_report is not None and pred_report.steps == 1
            and pred_report.coverage_pct > 50.0,
            "predict's profile window names its layers")
    eval_labels = [k for k in tcm.compile_stats()["per_function"]
                   if k.startswith("eval_step")]

    # -- files ----------------------------------------------------------------
    lines = [json.loads(line) for line in open(jsonl)]
    for e in lines:
        missing = set(tt.EVENT_GOLDEN_KEYS.get(e["kind"], ())) - set(e)
        require(not missing, f"JSONL {e['kind']} line has its golden keys "
                f"({missing})")
    kinds = {e["kind"] for e in lines}
    require({"span", "health", "profile", "epoch_summary", "memory_plan",
             "memory_watermark"} <= kinds, f"the JSONL's kinds ({kinds})")
    dump = model.telemetry.dump_flight(reason="chip_smoke")
    ok, payload = tt.validate_flight(dump)
    require(ok, f"the flight dump validates ({payload})")
    records = tt.read_ledger(ledger_dir)
    require([r["kind"] for r in records] == ["fit", "predict"],
            f"the ledger's records ({[r.get('kind') for r in records]})")
    sidecars = [mt.utils.checkpoint.check_sidecar(p) for p in
                glob.glob(f"{ledger_dir}/run-*.json")]
    require(sidecars == [True, True], f"the ledger's CRCs ({sidecars})")
    locks = lockwatch.report()
    require(locks["enabled"] and locks["cycles"] == [],
            f"no lock-order cycle ({locks['cycles']})")
    acquires_per_step = locks["acquires"] / TELEMETRY_STEPS
    armed_ns = lock_pair_ns(lockwatch, True)
    bare_ns = lock_pair_ns(lockwatch, False)
    lockwatch.disable()

    # -- memory -------------------------------------------------------------
    plans = {k: tcm.memory_plan_for(k) for k in [label, *eval_labels]}
    require(all(p is not None and p["temp_bytes"] > 0
                for p in plans.values()),
            f"each captured program's plan ({plans})")
    for k in ("MXNET_TPU_FLIGHT_DIR", "MXNET_TPU_LEDGER_DIR",
              "MXNET_TPU_LOCKWATCH"):
        del os.environ[k]
    emit({"phase": "telemetry", "model": "resnet50", "batch": BATCH,
          "compute_dtype": "bfloat16", "steps": TELEMETRY_STEPS,
          "window": TELEMETRY_WINDOW,
          "eager": fit_stats["eager"], "train_program": label,
          "replays": counts["replays"], "captures": counts["captures"],
          "fused_adam_launches": launches["fused_adam"],
          "health_step": TELEMETRY_HEALTH_STEP,
          "health_rel_err_vs_f64": health_err,
          "health_bound": TELEMETRY_HEALTH_BOUND,
          "planted_nan": {"layer": victim_layer, "blamed": list(blamed)},
          "profile": {"device_ms": report.total_us / 1e3,
                      "coverage_pct": report.coverage_pct,
                      "unattributed_ms": report.unattributed_us / 1e3,
                      "device_events": len(device),
                      "window_timeline_device_ms": window_device_ms,
                      "window_timeline_dispatch_device_ms": window_step_ms,
                      "layers_top_ms": [
                          [k, v / 1e3] for k, v in sorted(
                              report.layers.items(),
                              key=lambda kv: -kv[1])[:6]],
                      "fused_adam": adam_rows[0],
                      "predict_coverage_pct": pred_report.coverage_pct},
          "flops": {"per_step": acct.flops_per_step,
                    "contraction": acct.contraction_flops,
                    "analytic_contraction": analytic,
                    "contraction_rel_err": flop_err},
          "measured_bf16_peak_tflops": peak / 1e12,
          "mfu_pct_at_off_step": mfu_pct,
          "step_ms": {"telemetry_health_on": on_ms, "off": off_ms,
                      "replay_device_phase_median": replay_device_ms},
          "lockwatch": {"cycles": 0, "acquires_per_step": acquires_per_step,
                        "armed_pair_ns": armed_ns, "bare_pair_ns": bare_ns,
                        "armed_overhead_ms_per_step":
                            acquires_per_step * (armed_ns - bare_ns) / 1e6},
          "memory": {"plans": plans,
                     "live_array_watermark_bytes":
                         watermark["ledger"]["watermark_bytes"],
                     "max_memory_allocated_bytes":
                         torch.cuda.max_memory_allocated()},
          "files": {"jsonl_lines": len(lines), "flight": dump,
                    "ledger_records": len(records)}})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- slice 19: the collective table, guards, chaos, preemption -----------------

GUARD_STEPS = 8
GUARD_NAN_STEP = 3          # the guarded step step.nan poisons (0-based)
GUARD_BF16_STEPS = 6
GUARD_BF16_SCALE = 2.0 ** 15
GUARD_TIMED_STEPS = 16
GUARD_TIMED_SKIP = 3        # warm-up, capture and one more left out
GUARD_TIMED_RUNS = 2        # unguarded, guarded, in turn
GUARD_COST_BOUND = 0.05     # tests/test_resilience.py:269's bound
GUARD_SIGTERM_AFTER = 4     # SIGTERM after this many steps
GUARD_DIR = "build/chip_smoke/guards"
COMM_TABLE_STEPS = 2


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN's deterministic algorithms for a run whose result is compared
    bitwise with another run's (a harness setting of this script, not of
    the port)."""
    det, bench = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench


def guard_state_copy(torch, model):
    """Device copies of what a guarded step moves: parameters, Adam's two
    moments and the running statistics."""
    from mxnet_tpu_torch.model import _moved_opt_leaves

    st = model._train_state
    with torch.no_grad():
        return ([v.detach().clone() for v in st.params.values()]
                + [t.clone() for t in _moved_opt_leaves(st.optimizer,
                                                        st.opt_state)]
                + [v.clone() for v in st.aux.values()])


def guarded_fit(torch, mt, net, args, aux, X, Y, guards, rules=None,
                hook=None, **kw):
    """One ``fit(guards=)`` of ResNet-50 on the card (fused Adam), chaos
    armed with ``rules``; ``hook(model, step)`` runs after each step (the
    step's results on the card). Returns the model and the kernels'
    launches read around the fit."""
    from mxnet_tpu_torch.resilience import chaos_scope

    kw = {"optimizer": "adam", "fused": True, "learning_rate": LEARNING_RATE,
          **kw}
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, arg_params=args,
                           aux_params=aux, **kw)
    done = [0]

    def step_hook(_batch, _arrays):
        done[0] += 1
        if hook is not None:
            hook(model, done[0])

    model._step_hook = step_hook
    torch.cuda.synchronize()
    reset_launches()
    with chaos_scope(seed=SEED, rules=rules or {}):
        model.fit(mt.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=False),
                  guards=guards)
    torch.cuda.synchronize()
    return model, read_launches()


def phase_guards(torch, mt):
    """``fit(guards=True)`` of the full-width ResNet-50 (batch 32, f32,
    fused Adam, captured), ``step.nan`` poisoning one step: the skipped
    step leaves parameters, moments and running statistics bitwise as they
    were, ``fused_adam`` launched every step; the captured guarded fit
    bitwise the eager one (cuDNN deterministic in both); a bf16 fit with a
    dynamic loss scale backing off; the guarded captured step's median
    against the unguarded one's; SIGTERM mid-epoch flushing a
    step-granular checkpoint and raising TrainingPreempted, the resumed
    fit bitwise the uninterrupted one. Returns the main path's launches
    (the first guarded fit, counted by replay)."""
    import os
    import shutil
    import signal

    from mxnet_tpu_torch.resilience import GuardConfig, TrainingPreempted
    from mxnet_tpu_torch.utils import checkpoint as tck

    mt.set_matmul_precision("highest")
    set_graphs(True)
    shutil.rmtree(GUARD_DIR, ignore_errors=True)
    os.makedirs(GUARD_DIR)
    net, args, aux, batch_x, batch_y = resnet50_case()
    rng = np.random.default_rng(SEED + 19)
    X = rng.standard_normal((GUARD_STEPS * BATCH,) + IMAGE, np.float32)
    X[:BATCH] = batch_x
    Y = rng.integers(0, 1000, GUARD_STEPS * BATCH).astype(np.float32)
    nan = {"step.nan": {GUARD_NAN_STEP}}

    # the main path: the captured guarded fit, one step poisoned
    seen = {}

    def watch(model, step):
        if step in (GUARD_NAN_STEP, GUARD_NAN_STEP + 1):
            seen[step] = guard_state_copy(torch, model)

    model, launches = guarded_fit(torch, mt, net, args, aux, X, Y, True,
                                  rules=nan, hook=watch)
    st = model._train_state
    before, after = seen[GUARD_NAN_STEP], seen[GUARD_NAN_STEP + 1]
    require(all(bits_equal(torch, a, b) for a, b in zip(before, after)),
            "guards: the skipped step left parameters, moments and running "
            "statistics bitwise as they were")
    require(model.guard_stats == {"skipped_steps": 1, "step_retries": 0,
                                  "loss_scale": 1.0},
            f"guards: guard_stats {model.guard_stats}")
    require(launches["fused_adam"] == GUARD_STEPS,
            f"guards: fused_adam launched {launches['fused_adam']} times in "
            f"{GUARD_STEPS} guarded steps (counted by replay)")
    captured = [p for p in st.programs.values() if p.captured.captured]
    require(len(st.programs) == 1 and len(captured) == 1,
            "guards: the guarded step captured once")
    require(all(bool(torch.isfinite(v).all())
                for v in model.arg_params.values()),
            "guards: finite parameters after the poisoned step")
    t_counts = sorted({float(st.opt_state[k][2]) for k in st.opt_state})
    require(t_counts == [GUARD_STEPS - 1.0],
            f"guards: Adam's step counts {t_counts} skip the poisoned step")
    moved = max_gap(torch, model.arg_params,
                    {k: torch.from_numpy(v) for k, v in args.items()})
    del model, st, seen, before, after, captured
    torch.cuda.empty_cache()

    # the captured guarded fit against the eager one, bitwise
    runs = {}
    with cudnn_deterministic(torch):
        for mode in ("captured", "eager"):
            set_graphs(mode == "captured")
            m, _ = guarded_fit(torch, mt, net, args, aux, X, Y, True,
                               rules=nan)
            runs[mode] = (dict(m.arg_params), dict(m.aux_params),
                          m.guard_stats)
            del m
            torch.cuda.empty_cache()
    set_graphs(True)
    require(runs["captured"][2] == runs["eager"][2],
            "guards: captured and eager guard_stats")
    for i, what in ((0, "parameters"), (1, "running statistics")):
        require(all(bits_equal(torch, runs["captured"][i][k], v)
                    for k, v in runs["eager"][i].items()),
                f"guards: the captured guarded fit's {what} bitwise the "
                "eager one's")
    del runs

    # bf16 with a dynamic loss scale: the poisoned step backs it off
    cfg = GuardConfig(dynamic_loss_scale=True, init_scale=GUARD_BF16_SCALE,
                      growth_interval=1000)
    m, bf16_launches = guarded_fit(
        torch, mt, net, args, aux, X[:GUARD_BF16_STEPS * BATCH],
        Y[:GUARD_BF16_STEPS * BATCH], cfg, rules={"step.nan": {2}},
        compute_dtype=torch.bfloat16)
    bf16_stats = dict(m.guard_stats)
    require(bf16_stats["skipped_steps"] == 1
            and bf16_stats["loss_scale"] == GUARD_BF16_SCALE * 0.5,
            f"guards: the bf16 scale backed off once: {bf16_stats}")
    require(bf16_launches["fused_adam"] == GUARD_BF16_STEPS,
            "guards: fused_adam once a bf16 guarded step")
    del m
    torch.cuda.empty_cache()

    # the cost: the captured step's median, unguarded and guarded in turn
    Xt, Yt = repeat_batch(batch_x, batch_y, GUARD_TIMED_STEPS)
    times = {"unguarded": [], "guarded": []}
    for _ in range(GUARD_TIMED_RUNS):
        for tag, g in (("unguarded", None), ("guarded", True)):
            stamps = []

            def clock(_model, _step):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            m, _ = guarded_fit(torch, mt, net, args, aux, Xt, Yt, g,
                               hook=clock)
            times[tag].extend((b - a) * 1e3 for a, b in zip(
                stamps[GUARD_TIMED_SKIP:], stamps[GUARD_TIMED_SKIP + 1:]))
            del m
            torch.cuda.empty_cache()
    medians = {k: statistics.median(v) for k, v in times.items()}
    cost = medians["guarded"] / medians["unguarded"] - 1.0

    # SIGTERM mid-epoch: the flush, TrainingPreempted, the resume
    def ckpt_fit(d, after=None):
        m = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="adam",
                           fused=True, learning_rate=LEARNING_RATE,
                           arg_params=args, aux_params=aux)
        done = [0]

        def term(*_a):
            # the signal lands mid-epoch; fit flushes at the next step
            done[0] += 1
            if done[0] == after:
                os.kill(os.getpid(), signal.SIGTERM)

        m._step_hook = term
        try:
            m.fit(mt.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=False),
                  guards=True, sharded_checkpoint_dir=d,
                  checkpoint_every_n_steps=100)
        except TrainingPreempted as e:
            return m, e
        return m, None

    with cudnn_deterministic(torch):
        ref, none = ckpt_fit(f"{GUARD_DIR}/ref")
        require(none is None, "guards: the uninterrupted fit ran through")
        ref_params = dict(ref.arg_params)
        del ref
        torch.cuda.empty_cache()
        d = f"{GUARD_DIR}/sigterm"
        t0 = time.perf_counter()
        killed, exc = ckpt_fit(d, after=GUARD_SIGTERM_AFTER)
        flush_s = time.perf_counter() - t0
        require(exc is not None, "guards: SIGTERM raised TrainingPreempted")
        step = tck.latest_step(d)
        meta = tck.load_sharded(d, step)[3]
        require(meta.get("preempted") and meta["batches_done"]
                == GUARD_SIGTERM_AFTER and step == GUARD_SIGTERM_AFTER,
                f"guards: the flush saved step {step} with {meta}")
        del killed
        torch.cuda.empty_cache()
        resumed, none = ckpt_fit(d)
        require(none is None and resumed.begin_epoch == 0,
                "guards: the resumed fit ran through")
        require(all(bits_equal(torch, resumed.arg_params[k], v)
                    for k, v in ref_params.items()),
                "guards: the resumed fit's parameters bitwise the "
                "uninterrupted fit's")
        del resumed, ref_params
    torch.cuda.empty_cache()
    shutil.rmtree(GUARD_DIR, ignore_errors=True)
    emit({"phase": "guards", "model": "resnet50", "batch": BATCH,
          "optimizer": "adam", "fused": True, "captured": True,
          "steps": GUARD_STEPS, "nan_step": GUARD_NAN_STEP,
          "skipped_step_bitwise": True, "guard_stats": {
              "skipped_steps": 1, "step_retries": 0, "loss_scale": 1.0},
          "launches": launches, "params_moved_max": moved,
          "captured_bitwise_eager": True,
          "bf16_dynamic_scale": bf16_stats,
          "step_ms_median": medians, "step_ms": times,
          "guard_cost": cost, "guard_cost_bound": GUARD_COST_BOUND,
          "guard_cost_within_bound": cost < GUARD_COST_BOUND,
          "card": nvidia_smi("name,power.limit"),
          "sigterm_after_steps": GUARD_SIGTERM_AFTER,
          "sigterm_flush_step": GUARD_SIGTERM_AFTER,
          "sigterm_fit_s": flush_s, "resume_bitwise": True})
    return launches


def comm_table_rank(torch, rank, world, mode):
    """One rank's comm_table run in ``mode``: dp_overlap's fit (4 MB
    buckets, the comm kernels) for COMM_TABLE_STEPS steps under
    ``torch.profiler``, its collective table, a ``Monitor(track_comm)``'s
    rows and the registry's delta; then the largest bucket's exchange
    alone, profiled with the kernels and with the codec."""
    from torch.profiler import ProfilerActivity, profile

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import comm

    net, args, aux, X, Y = dp_rank_data(rank, world)
    Xs, Ys = repeat_batch(X, Y, COMM_TABLE_STEPS)
    comm.reset_comm_stats()
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="adam",
                           fused=True, learning_rate=LEARNING_RATE,
                           arg_params=args, aux_params=aux)
    mon = mt.Monitor(1, track_comm=True)
    before = comm.registry().snapshot()
    torch.cuda.synchronize()
    reset_launches()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # the schedule's comm thread issues the buckets: record every thread
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with profile(activities=activities, record_shapes=True,
                 experimental_config=every_thread) as prof:
        model.fit(mt.io.NDArrayIter(Xs, Ys, batch_size=BATCH),
                  kvstore="dist_sync", compression=mode, comm_kernels=True,
                  overlap=DP_OVERLAP_BUCKET_BYTES)
        torch.cuda.synchronize()
    launches = read_launches()
    after = comm.registry().snapshot()
    rows = {name: v for _s, name, v in mon.collect_comm()}
    plan = model._train_state.grad_sync.plan
    table = comm.collective_table(prof)
    del model, prof
    torch.cuda.empty_cache()
    spec = comm.CompressionSpec(mode)
    padded = max(comm.padded_flat_size(n, spec, world)
                 for _, n in plan.bucket_elems())
    flat = torch.from_numpy(np.random.default_rng(SEED + rank)
                            .standard_normal(padded, np.float32)).cuda()
    passes = {}
    for tag, kernels in (("kernels", comm.CommKernelConfig()),
                         ("codec", None)):
        with profile(activities=activities, record_shapes=True) as prof:
            comm.error_feedback_exchange(flat.clone(), spec, None, world,
                                         kernels)
            torch.cuda.synchronize()
        passes[tag] = comm.quantize_pass_count(prof, padded)
        del prof
    return {"launches": launches, "table": table,
            "bucket_elems": plan.bucket_elems(), "monitor": rows,
            "registry_delta": {k: after[k] - before[k]
                               for k in ("steps", "wire_bytes",
                                         "fp32_wire_bytes")},
            "slab_elements": padded, "passes": passes}


def comm_table_body(torch, rank, world):
    return {mode: comm_table_rank(torch, rank, world, mode)
            for mode in DP_MODES}


def phase_comm_table(torch, comm):
    """dp_overlap's two ranks, int8 and twobit, 2 steps each under
    ``torch.profiler``: the profiled collective table against
    ``comm.overlap_plan``, exactly, op by op; the slab-sized quantize
    passes with the kernels (0) and with the codec (more); the Monitor's
    ``comm/*`` rows against the registry's delta. Returns rank 0's
    launches, both modes together."""
    ranks = run_ranks(torch, comm_table_body, DP_WORLD, DP_TIMEOUT_S,
                      "comm_table")
    launches = {n: 0 for n in port_kernels()}
    for mode in DP_MODES:
        r0 = ranks[0][mode]
        plan = comm.overlap_plan(r0["bucket_elems"], DP_WORLD, mode)
        buckets = len(r0["bucket_elems"])
        want = {r["op"]: (COMM_TABLE_STEPS * r["payload_bytes"],
                          COMM_TABLE_STEPS * r["wire_bytes"])
                for r in plan["collectives"]}
        for rank, res in enumerate(ranks):
            got = res[mode]
            table = {r["op"]: (r["payload_bytes"], r["wire_bytes"])
                     for r in got["table"]}
            require({op: table.get(op) for op in want} == want,
                    f"comm_table {mode} rank {rank}: the profiled table "
                    f"{table} against overlap_plan x {COMM_TABLE_STEPS} "
                    f"{want}")
            require(got["passes"]["kernels"] == 0
                    and got["passes"]["codec"] > 0,
                    f"comm_table {mode} rank {rank}: slab-sized quantize "
                    f"passes {got['passes']} (kernels 0, codec more)")
            delta = got["registry_delta"]
            require(got["monitor"]["comm/wire_bytes"] == delta["wire_bytes"]
                    == COMM_TABLE_STEPS * plan["wire_bytes"]
                    and got["monitor"]["comm/steps"] == delta["steps"]
                    == COMM_TABLE_STEPS
                    and got["monitor"]["comm/fp32_wire_bytes"]
                    == delta["fp32_wire_bytes"],
                    f"comm_table {mode} rank {rank}: Monitor rows "
                    f"{got['monitor']} against the registry's delta {delta}")
            for name, count in got["launches"].items():
                per = DP_LAUNCHES[mode].get(name, 0)
                expect = COMM_TABLE_STEPS * (per if name == "fused_adam"
                                             else per * buckets)
                require(count == expect,
                        f"comm_table {mode} rank {rank}: {name} launched "
                        f"{count} times, expected {expect}")
        emit({"phase": "comm_table", "mode": mode, "model": "resnet50",
              "world": DP_WORLD, "steps": COMM_TABLE_STEPS,
              "bucket_bytes": DP_OVERLAP_BUCKET_BYTES, "buckets": buckets,
              "table_rank0": r0["table"],
              "plan_collectives": plan["collectives"],
              "table_equals_plan": True,
              "other_ops": sorted({r["op"] for r in r0["table"]}
                                  - set(want)),
              "slab_elements": r0["slab_elements"],
              "quantize_passes": r0["passes"],
              "monitor_rows": r0["monitor"],
              "registry_delta": r0["registry_delta"],
              "launches": r0["launches"]})
        for name, count in r0["launches"].items():
            launches[name] += count
    return launches


# -- slice 21: the analysis passes ------------------------------------------

VERIFY_REPS = 7             # binds a setting, the median kept
SHARD_AUDIT_STEPS = 2       # steps of each audited fit


def resnet_tensors(torch, args, aux, batch_x, batch_y, dtype, device="cuda"):
    """ResNet-50's arguments (labels f32), zero gradients and auxiliary
    states at ``dtype`` on ``device``: what a training bind takes."""
    values = {k: torch.from_numpy(v).to(device, dtype) for k, v in args.items()}
    values["data"] = torch.from_numpy(batch_x).to(device, dtype)
    values["softmax_label"] = torch.from_numpy(batch_y).to(device)
    return (values, {k: torch.zeros_like(values[k]) for k in args},
            {k: torch.from_numpy(v).to(device, dtype) for k, v in aux.items()})


def bind_resnet(mt, net, tensors, device="cuda"):
    """A training bind of ResNet-50 over ``resnet_tensors``' tensors,
    gradients written."""
    values, grads, aux = tensors
    return net.bind(mt.gpu(0) if device == "cuda" else mt.cpu(), values,
                    args_grad=grads,
                    grad_req={k: "write" if k in grads else "null"
                              for k in net.list_arguments()},
                    aux_states=aux)


def phase_verify(torch, mt):
    """Graph verification on every bind: full-width ResNet-50 at batch 32
    bound on the card in f32 and bf16 with ``MXNET_TPU_VERIFY`` on and off,
    the median host time of each bind and of ``Symbol.verify`` alone, and
    verify's share of one captured training step (forward and backward
    replayed, device time); a seeded shape conflict raises MXNetError
    naming MX402 and its node. Returns the launches (none: binds run no
    kernel) and the bf16 executor, for program_audit."""
    import os

    from mxnet_tpu_torch.base import MXNetError

    net, args, aux, batch_x, batch_y = resnet50_case()
    reset_launches()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tensors = resnet_tensors(torch, args, aux, batch_x, batch_y, dtype)
        binds = {}
        for flag in ("1", "0"):
            os.environ["MXNET_TPU_VERIFY"] = flag
            samples = []
            for _ in range(VERIFY_REPS):
                t0 = time.perf_counter()
                bind_resnet(mt, net, tensors)
                samples.append(time.perf_counter() - t0)
            binds[flag] = statistics.median(samples) * 1e3
        del os.environ["MXNET_TPU_VERIFY"]
        ex = bind_resnet(mt, net, tensors)
        shapes = {k: tuple(v.shape) for k, v in ex.arg_dict.items()}
        dtypes = {k: mt.ops.registry.as_dtype(v.dtype)
                  for k, v in ex.arg_dict.items()}
        samples = []
        for _ in range(VERIFY_REPS):
            t0 = time.perf_counter()
            findings = net.verify(arg_shapes=shapes, arg_dtypes=dtypes)
            samples.append(time.perf_counter() - t0)
        verify_ms = statistics.median(samples) * 1e3
        require(not [f for f in findings if f.is_error],
                f"verify: ResNet-50 {dtype} verifies clean")
        ex.precompile(is_train=True)

        def step():
            ex.forward(is_train=True)
            ex.backward()

        step_ms = time_ms(torch, step, reps=5)
        out[str(dtype).split(".")[-1]] = (ex, {
            "bind_ms_verify_on": binds["1"], "bind_ms_verify_off": binds["0"],
            "verify_ms": verify_ms, "captured_step_ms": step_ms,
            "verify_share_of_step": verify_ms / step_ms,
            "findings": sorted({f.rule.id for f in findings})})
    # a seeded shape conflict: the first convolution's weight one filter short
    weight = next(k for k in net.list_arguments() if k.endswith("_weight"))
    node = weight[:-len("_weight")]
    bad = {k: np.zeros((v.shape[0] - 1,) + v.shape[1:], np.float32)
           if k == weight else v for k, v in args.items()}
    try:
        bind_resnet(mt, net, resnet_tensors(torch, bad, aux, batch_x, batch_y,
                                            torch.float32))
    except MXNetError as e:
        message = str(e)
    else:
        message = ""
    require("MX402" in message and f"'{node}'" in message,
            f"verify: a seeded shape conflict at {node} raised MX402 naming "
            f"it ({message[:200]!r})")
    launches = read_launches()
    emit({"phase": "verify", "model": "resnet50", "batch": BATCH,
          **{dt: row for dt, (_, row) in out.items()},
          "seeded_conflict": {"node": node, "rule": "MX402"},
          "launches": launches})
    return launches, out["bfloat16"][0]


def phase_program_audit(torch, mt, ex):
    """The program audit of verify's bf16 ResNet-50 training executor on
    the card: its findings (rule, node, range) equal to the CPU's audit of
    the same graph (batch 2) and all MX502, its contraction FLOPs equal to
    a ``FlopCounter`` over the same forward, a ``_Native`` node one MX501,
    and the launches and host seconds around the audit."""
    import re

    from mxnet_tpu_torch import analysis
    from mxnet_tpu_torch.executor import _build_graph_fn
    from mxnet_tpu_torch.telemetry.mfu import FlopCounter

    def keyed(findings):
        return sorted((f.rule.id, f.node,
                       (re.findall(r" in '([^']+)'$", f.message) or [""])[0])
                      for f in findings)

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    card = analysis.audit_executor(ex, is_train=True,
                                   intended_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    audit_s = time.perf_counter() - t0
    launches = read_launches()
    net = ex._symbol
    fn = _build_graph_fn(net, True)
    args = dict(ex.arg_dict)
    aux = {k: v.clone() for k, v in ex.aux_dict.items()}
    dev = ex._ctx.torch_device
    gen = torch.Generator(device=dev).manual_seed(0)
    counter = FlopCounter()
    with counter, torch.no_grad():
        fn(args, aux, gen)
    require(card.totals["contraction_flops"] == counter.contraction_flops > 0,
            f"program_audit: contraction FLOPs {card.totals} against the "
            f"FlopCounter's {counter.contraction_flops}")
    _, cargs, caux, batch_x, batch_y = resnet50_case()
    host_ex = bind_resnet(mt, net, resnet_tensors(
        torch, cargs, caux, batch_x[:2], batch_y[:2], torch.bfloat16, "cpu"),
        device="cpu")
    host = analysis.audit_executor(host_ex, is_train=True,
                                   intended_dtype=torch.bfloat16)
    require(keyed(card.findings) == keyed(host.findings)
            and {f.rule.id for f in card.findings} <= {"MX502"},
            f"program_audit: card findings {keyed(card.findings)} against "
            f"the CPU's {keyed(host.findings)}")

    class Twice(mt.operator.NumpyOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = 2 * in_data[0]

    native = Twice()(data=mt.sym.Variable("data"), name="twice")
    nex = native.bind(mt.gpu(0), {"data": torch.ones(4, 3, device=dev)})
    nrep = analysis.audit_executor(nex)
    require([(f.rule.id, f.node) for f in nrep.findings]
            == [("MX501", "twice")],
            f"program_audit: a _Native node gives one MX501 "
            f"({[f.format() for f in nrep.findings]})")
    emit({"phase": "program_audit", "model": "resnet50", "batch": BATCH,
          "dtype": "bfloat16", "findings": keyed(card.findings),
          "cpu_findings_equal": True, "totals": card.totals,
          "flop_counter_contraction_flops": counter.contraction_flops,
          "native_findings": [f.format() for f in nrep.findings],
          "audit_host_s": audit_s, "launches": launches})
    return launches


def shard_audit_rank(torch, rank, world, mode, audit=True, wrong_plan=None):
    """One rank's fit: dp_overlap's model, rows and overlapped exchange
    with the comm kernels for SHARD_AUDIT_STEPS steps of
    ``fit(shard_audit=audit)``; with ``wrong_plan`` the audit holds the
    step to that mode's plan and must raise MX802 before a step moves a
    parameter. Returns the reports, the launches read around the fit, the
    audit's seconds and the fit's."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import comm
    from mxnet_tpu_torch.base import MXNetError

    net, args, aux, X, Y = dp_rank_data(rank, world)
    Xs, Ys = repeat_batch(X, Y, SHARD_AUDIT_STEPS)
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="adam",
                           fused=True, learning_rate=LEARNING_RATE,
                           arg_params=args, aux_params=aux)
    if wrong_plan is not None:
        def plan_of(sync):
            return (comm.allreduce_plan(sync.size, sync.num_workers,
                                        wrong_plan),
                    comm.CompressionSpec(wrong_plan))

        model._shard_audit_plan = plan_of
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    error = None
    try:
        model.fit(mt.io.NDArrayIter(Xs, Ys, batch_size=BATCH),
                  kvstore="dist_sync", compression=mode, comm_kernels=True,
                  overlap=DP_OVERLAP_BUCKET_BYTES, shard_audit=audit)
    except MXNetError as e:
        error = str(e)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    res = {"launches": read_launches(), "fit_s": fit_s,
           "audit_s": model.shard_audit_seconds, "error": error,
           "reports": [{
               "findings": [f.format() for f in rep.findings],
               "matched": rep.reconciliation.get("matched"),
               "stat_rows": rep.reconciliation.get("stat_rows"),
               "unplanned": rep.reconciliation.get("unplanned"),
               "notes": rep.reconciliation.get("notes"),
               "aux_elements": rep.reconciliation.get("aux_elements"),
               "table": rep.table} for rep in model.shard_audit_reports]}
    if wrong_plan is not None:
        # every rank starts from rank 0's weights (the broadcast)
        first = dp_rank_data(0, world)[1]
        res["params_initial"] = all(
            np.array_equal(v.detach().cpu().numpy(), first[k])
            for k, v in model._train_state.params.items())
    return res


def shard_audit_body(torch, rank, world):
    """Each mode's fit without the audit, then with it (the first warms the
    process, so the difference is what the audit adds), then a twobit fit
    held to int8's plan."""
    out = {}
    for mode in DP_MODES:
        out[f"{mode}_plain"] = shard_audit_rank(torch, rank, world, mode,
                                                audit=None)
        out[mode] = shard_audit_rank(torch, rank, world, mode)
    out["wrong_plan"] = shard_audit_rank(torch, rank, world, "twobit",
                                         wrong_plan="int8")
    return out


def phase_shard_audit(torch, comm):
    """The sharding audit through ``fit(shard_audit=True)`` on comm_table's
    two ranks (int8 and twobit, overlap and the comm kernels on): each fit
    trains, its one report holds matched rows and no finding, int8's codes
    and scales a named note (twice the plan's collectives, payload and wire
    bytes the plan's), BatchNorm's averaged statistics a planned row; a
    twobit fit held to int8's plan raises MX802 with the parameters
    bitwise the initial ones. Prints what the audit adds to a fit: the
    audited fit's seconds less the same fit's without it, run just before
    in the same process. Returns rank 0's launches of the audited fits,
    both modes."""
    ranks = run_ranks(torch, shard_audit_body, DP_WORLD, DP_TIMEOUT_S,
                      "shard_audit")
    launches = {n: 0 for n in port_kernels()}
    for mode in DP_MODES:
        for rank, res in enumerate(ranks):
            got = res[mode]
            require(res[f"{mode}_plain"]["error"] is None
                    and res[f"{mode}_plain"]["reports"] == [],
                    f"shard_audit {mode} rank {rank}: the fit without the "
                    f"audit trained unaudited")
            require(got["error"] is None and len(got["reports"]) == 1,
                    f"shard_audit {mode} rank {rank}: trained with one "
                    f"report ({got['error']})")
            (rep,) = got["reports"]
            require(rep["findings"] == [] and rep["matched"]
                    and rep["unplanned"] == [] and rep["aux_elements"] > 0,
                    f"shard_audit {mode} rank {rank}: report {rep}")
            notes = {r["op"]: r for r in rep["notes"]}
            want = {"all-to-all", "all-gather"} if mode == "int8" else set()
            require(set(notes) == want and all(
                r["profiled_count"] == 2 * r["plan_count"]
                and r["payload_bytes"] == r["plan_payload_bytes"]
                and r["wire_bytes"] == r["plan_wire_bytes"]
                for r in notes.values()),
                f"shard_audit {mode} rank {rank}: notes {rep['notes']}")
        r0 = ranks[0][mode]
        emit({"phase": "shard_audit", "mode": mode, "model": "resnet50",
              "world": DP_WORLD, "steps": SHARD_AUDIT_STEPS,
              "bucket_bytes": DP_OVERLAP_BUCKET_BYTES,
              "matched_rows": len(r0["reports"][0]["matched"]),
              "notes": r0["reports"][0]["notes"],
              "stat_rows": r0["reports"][0]["stat_rows"],
              "aux_elements": r0["reports"][0]["aux_elements"],
              "audit_s": [r[mode]["audit_s"] for r in ranks],
              "fit_s": [r[mode]["fit_s"] for r in ranks],
              "fit_s_without_audit": [r[f"{mode}_plain"]["fit_s"]
                                      for r in ranks],
              "audit_adds_s": [r[mode]["fit_s"] - r[f"{mode}_plain"]["fit_s"]
                               for r in ranks],
              "launches": [r[mode]["launches"] for r in ranks]})
        for name, count in r0["launches"].items():
            launches[name] += count
    for rank, res in enumerate(ranks):
        got = res["wrong_plan"]
        require(got["error"] is not None and "MX802" in got["error"]
                and got["params_initial"],
                f"shard_audit wrong plan rank {rank}: raised MX802 with the "
                f"parameters initial ({got['error']}, "
                f"{got.get('params_initial')})")
    emit({"phase": "shard_audit", "mode": "twobit_on_int8_plan",
          "error": ranks[0]["wrong_plan"]["error"][:300],
          "params_initial": True,
          "audit_s": [r["wrong_plan"]["audit_s"] for r in ranks]})
    for name in ("quant_int8", "dequant_sum_int8"):
        require(launches[name] > 0, f"shard_audit launched {name}")
    return launches


# -- slice 20: elastic resizing and the fleet controller ----------------------

ELASTIC_WORLD = 4           # ranks: [gpu(0)] * 4, aliased replicas
ELASTIC_BATCH = 48          # divides 4, 3 and 2: every world the phases take
ELASTIC_STEPS = 4           # steps an epoch
ELASTIC_EPOCHS = 3
# elastic.kill's and elastic.rejoin's occurrences (one poll a step,
# counted from 0): the kill before epoch 1's 4th step, the rejoin before
# epoch 2's 3rd (after epoch 1 was redone on 3)
ELASTIC_KILL_AT = ELASTIC_STEPS + 3
ELASTIC_REJOIN_AT = ELASTIC_KILL_AT + ELASTIC_STEPS + 3
ELASTIC_MEMORY_BOUND = 0.05
ELASTIC_DIR = "build/chip_smoke/elastic"
CTL_STRAGGLER, CTL_FLAKY = 3, 2
CTL_STALL_S = 0.05          # the straggler's real sleep a step
CTL_SPAN_MS = 2.0           # a healthy rank's step in the scripted spans
CTL_HEARTBEAT_S = 1.0
CTL_OUTAGE_STEP = 1         # the flaky rank falls silent from this step
CTL_RATIO = 0.5             # comm:compute the scaled wire gives: int8
CTL_FREEZE_STEPS = 3
CTL_STEPS = 6               # steps an epoch of the controller's first fit


def elastic_data(shape_rows):
    rng = np.random.default_rng(SEED + 20)
    X = rng.standard_normal((shape_rows,) + IMAGE, np.float32)
    Y = rng.integers(0, 1000, shape_rows).astype(np.float32)
    return X, Y


def elastic_model(mt, net, args, aux, world, epochs):
    import torch

    return mt.FeedForward(
        net, ctx=[mt.gpu(0)] * world, num_epoch=epochs, optimizer="adam",
        fused=True, learning_rate=LEARNING_RATE,
        arg_params={k: torch.from_numpy(v) for k, v in args.items()},
        aux_params={k: torch.from_numpy(v) for k, v in aux.items()})


class LaunchesByKey:
    """A batch-end callback: the kernels' launches of each step, summed
    under ``key()`` (the world, the tier), and the card's allocated bytes
    after each step with ``key()`` and the step's place in its epoch; with
    ``collect``, after a garbage collection, so the bytes are what is
    reachable (earlier phases leave cycles that hold tensors)."""

    def __init__(self, torch, key, also=None, collect=False):
        self.torch, self.key, self.also = torch, key, also
        self.collect = collect
        self.by_key, self.memory = {}, []
        self.last = read_launches()

    def __call__(self, param):
        if self.collect:
            gc.collect()
        self.torch.cuda.synchronize()
        now = read_launches()
        got = self.by_key.setdefault(self.key(), {n: 0 for n in now})
        for n in now:
            got[n] += now[n] - self.last[n]
        self.last = now
        self.memory.append((self.key(), param.nbatch,
                            self.torch.cuda.memory_allocated()))
        if self.also is not None:
            self.also(param)


def fleet_threads():
    import threading

    return [t.name for t in threading.enumerate()
            if t.name in ("mx-fleet-ctl", "mx-heartbeat")]


def phase_elastic(torch, mt):
    """``fit(elastic=)`` of the full-width ResNet-50 (f32, fused Adam) over
    ``[gpu(0)] * 4``, batch 48, int8 with overlap, epoch checkpoints: a
    seeded ``elastic.kill`` mid-epoch 1 and ``elastic.rejoin`` in epoch 2
    (history [3, 4]); the redone epoch's checkpoint bitwise a fresh
    world-3 fit resumed from the copied pre-kill checkpoint (params, Adam
    moments, residual ledgers; cuDNN deterministic in both); resize badput
    above 0 and one resize span a resize; fused_adam and the int8 comm
    kernels launched on every world; the card's allocated memory after the
    regrow within 5% of before the kill. Returns the main path's launches
    (the elastic fit)."""
    import os
    import shutil

    from mxnet_tpu_torch import telemetry as ttel
    from mxnet_tpu_torch.resilience import ElasticCoordinator, chaos_scope
    from mxnet_tpu_torch.utils import checkpoint as tck

    mt.set_matmul_precision("highest")
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    os.makedirs(ELASTIC_DIR)
    net, args, aux, _, _ = resnet50_case()
    X, Y = elastic_data(ELASTIC_STEPS * ELASTIC_BATCH)
    d_el, d_ref = f"{ELASTIC_DIR}/elastic", f"{ELASTIC_DIR}/replay"
    jsonl = f"{ELASTIC_DIR}/events.jsonl"
    co = ElasticCoordinator(ELASTIC_WORLD)
    watch = LaunchesByKey(torch, lambda: (co.resizes, co.world_size),
                          collect=True)
    rules = {"elastic.kill": {ELASTIC_KILL_AT},
             "elastic.rejoin": {ELASTIC_REJOIN_AT}}
    with cudnn_deterministic(torch):
        model = elastic_model(mt, net, args, aux, ELASTIC_WORLD,
                              ELASTIC_EPOCHS)
        torch.cuda.synchronize()
        # the main path: each count set to 0 just before the fit
        reset_launches()
        watch.last = read_launches()
        t0 = time.perf_counter()
        with chaos_scope(seed=SEED, rules=rules):
            model.fit(mt.io.NDArrayIter(X, Y, batch_size=ELASTIC_BATCH,
                                        shuffle=False),
                      batch_size=ELASTIC_BATCH, elastic=co,
                      sharded_checkpoint_dir=d_el, compression="int8",
                      overlap=True, comm_kernels=True,
                      batch_end_callback=watch,
                      telemetry=ttel.TelemetryConfig(jsonl=jsonl,
                                                     memory=False))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_launches()
        require(co.resizes == 2 and [h["to"] for h in co.history]
                == [ELASTIC_WORLD - 1, ELASTIC_WORLD],
                f"elastic: two resizes, history {co.history}")
        require(len(model._train_state.members) == ELASTIC_WORLD,
                "elastic: the fit ended on 4 replicas")
        require(len(model.telemetry.steps(kind="resize")) == 2,
                "elastic: one resize span a resize")
        events = ttel.read_events(jsonl)
        badput = sum(e["seconds"] for e in events
                     if e.get("kind") == "badput"
                     and e.get("reason") == "resize")
        require(badput > 0, f"elastic: resize badput {badput}")
        worlds = {}
        for (resizes, world), got in watch.by_key.items():
            for name in ("fused_adam", "quant_int8", "dequant_sum_int8",
                         "dequant_int8"):
                require(got[name] > 0, f"elastic: {name} launched on world "
                        f"{world} (after {resizes} resizes): {got}")
            worlds[f"{resizes}:{world}"] = got
        # before the kill and after the regrow at the same place in an
        # epoch (the feed holds as many batches ahead at both)
        at, before_kill = [(n, b) for (r, _), n, b in watch.memory
                           if r == 0][-1]
        after_regrow = [b for (r, _), n, b in watch.memory
                        if r == 2 and n == at][-1]
        require(abs(after_regrow - before_kill)
                <= ELASTIC_MEMORY_BOUND * before_kill,
                f"elastic: allocated {after_regrow} bytes after the regrow, "
                f"{before_kill} before the kill, {at} steps into an epoch: "
                f"{watch.memory}")
        require(all(bool(torch.isfinite(v).all())
                     for v in model.arg_params.values()),
                "elastic: finite parameters")
        history = [dict(h, ranks=list(h["ranks"])) for h in co.history]
        del model
        torch.cuda.empty_cache()

        # the replay: a fresh world-3 fit resumed from the pre-kill
        # checkpoint (hard links of its files; an elastic coordinator with
        # no event, since a plain ctx list of one card is one replica)
        os.makedirs(d_ref)
        for step in (0, 1):
            shutil.copytree(f"{d_el}/{step}", f"{d_ref}/{step}",
                            copy_function=os.link)
        ref = elastic_model(mt, net, args, aux, ELASTIC_WORLD - 1, 2)
        t0 = time.perf_counter()
        ref.fit(mt.io.NDArrayIter(X, Y, batch_size=ELASTIC_BATCH,
                                  shuffle=False),
                batch_size=ELASTIC_BATCH,
                elastic=ElasticCoordinator(ELASTIC_WORLD - 1),
                sharded_checkpoint_dir=d_ref, compression="int8",
                overlap=True, comm_kernels=True)
        replay_s = time.perf_counter() - t0
        require(ref.begin_epoch == 1, "elastic: the replay resumed epoch 1")
        del ref
    torch.cuda.empty_cache()
    el = tck.load_sharded(d_el, 2, with_comm=True)
    rf = tck.load_sharded(d_ref, 2, with_comm=True)
    require(set(el[0]) == set(rf[0]) and all(
        np.array_equal(el[0][k], rf[0][k]) for k in el[0]),
        "elastic: the redone epoch's parameters bitwise the replay's")
    require(len(el[4]) == len(rf[4]) and all(
        np.array_equal(a, b) for a, b in zip(el[4], rf[4])),
        "elastic: the redone epoch's Adam moments bitwise the replay's")
    require(el[5] and set(el[5]) == set(rf[5]) and all(
        np.array_equal(el[5][k], rf[5][k]) for k in el[5]),
        "elastic: the redone epoch's residual ledgers bitwise the replay's")
    require(el[3]["num_update"] == rf[3]["num_update"]
            == 2 * ELASTIC_STEPS,
            f"elastic: both at step {2 * ELASTIC_STEPS}")
    del el, rf
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    emit({"phase": "elastic", "model": "resnet50", "batch": ELASTIC_BATCH,
          "ctx": f"[gpu(0)] * {ELASTIC_WORLD}", "compression": "int8",
          "overlap": True, "optimizer": "adam", "fused": True,
          "steps_an_epoch": ELASTIC_STEPS, "epochs": ELASTIC_EPOCHS,
          "chaos": {k: sorted(v) for k, v in rules.items()},
          "history": history,
          "downtime_s": [h["downtime_s"] for h in history],
          "resize_badput_s": badput,
          "memory_allocated": {
              "steps_into_epoch": at, "before_kill": before_kill,
              "after_regrow": after_regrow,
              "by_step": [[list(k), n, b] for k, n, b in watch.memory]},
          "replay_bitwise": True, "fit_s": fit_s, "replay_s": replay_s,
          "launches": launches, "launches_by_world": worlds,
          "card": nvidia_smi("name,power.limit")})
    return launches


class FleetFaults:
    """The controller phase's faults (tests/test_controller.py:467-513):
    the straggler rank stalls every step by a real sleep and its scripted
    span blames it; the flaky rank's heartbeats stop from CTL_OUTAGE_STEP
    until the coordinator buries it, then resume; a beater thread
    heartbeats every other rank every 20 ms."""

    def __init__(self, co):
        import threading

        self.co = co
        self.step = 0
        self._outage = self._recovered = False
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._beat, daemon=True,
                                       name="chip-smoke-beater")
        self.thread.start()

    def _beat(self):
        while not self._stop.wait(0.02):
            if self._outage and not self._recovered and \
                    self.co.last_heartbeat(CTL_FLAKY) is None:
                self._recovered = True
            silent = self._outage and not self._recovered
            for r in range(self.co.full_world_size):
                if not (r == CTL_FLAKY and silent):
                    self.co.heartbeat(r)

    def close(self):
        self._stop.set()
        self.thread.join(timeout=2.0)

    def __call__(self, param):
        from mxnet_tpu_torch import telemetry as ttel

        s = self.step
        self.step += 1
        if s >= CTL_OUTAGE_STEP:
            self._outage = True
        alive = self.co.alive
        if CTL_STRAGGLER in alive:
            time.sleep(CTL_STALL_S)
        for r in alive:
            d = CTL_STALL_S * 1e3 + CTL_SPAN_MS if r == CTL_STRAGGLER \
                else CTL_SPAN_MS
            ttel.emit("span", rank=r, name="step", epoch=0, step=s,
                      dur_ms=d, phases=[{"name": "device", "dur_ms": d}])


def phase_controller(torch, mt):
    """``fit(elastic=, controller=)`` of phase elastic's model and world,
    uncompressed at the start, with the JAX package's e2e faults
    (tests/test_controller.py:515-576): a straggler stalled by a real sleep
    and blamed through scripted spans, a flaky rank whose heartbeats stop
    and resume, the wire's rate scaled so the tier policy reads a
    comm:compute ratio of 0.5. Checks the straggler evicted once, the
    flaky rank backfilled, one retier actuated and its tier's comm kernels
    launched after it, the breaker closed, a valid flight dump with
    controller incidents, and no controller or heartbeat thread left. A
    second short fit stages an unappliable tier twice: the controller
    freezes and the fit finishes. Returns the main path's launches (the
    first fit)."""
    import os
    import shutil

    from mxnet_tpu_torch import comm
    from mxnet_tpu_torch import telemetry as ttel
    from mxnet_tpu_torch.resilience import (CircuitBreaker,
                                            ElasticCoordinator,
                                            FleetController)

    mt.set_matmul_precision("highest")
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    os.makedirs(ELASTIC_DIR)
    net, args, aux, _, _ = resnet50_case()
    X, Y = elastic_data(CTL_STEPS * ELASTIC_BATCH)
    elements = sum(int(v.size) for v in args.values())
    fp32_wire = comm.fp32_allreduce_wire_bytes(elements, ELASTIC_WORLD)
    wire_gbps = fp32_wire / (CTL_RATIO * CTL_SPAN_MS * 1e-3) / 1e9
    ttel.reset()
    ttel.flight.reset()
    co = ElasticCoordinator(ELASTIC_WORLD, heartbeat_timeout=CTL_HEARTBEAT_S)
    ctl = FleetController(
        interval=0.0, window=4, min_report_steps=4, evict_k=2, evict_n=4,
        max_evictions=1, rejoin_after=0.05, evaluate_after=0.5,
        cooldowns={"evict": 0.0, "backfill": 0.0, "retier": 0.0},
        wire_gbps=wire_gbps)
    faults = FleetFaults(co)
    watch = LaunchesByKey(torch, lambda: ctl._comm_mode, also=faults)
    model = elastic_model(mt, net, args, aux, ELASTIC_WORLD, ELASTIC_EPOCHS)
    torch.cuda.synchronize()
    reset_launches()
    watch.last = read_launches()
    t0 = time.perf_counter()
    try:
        model.fit(mt.io.NDArrayIter(X, Y, batch_size=ELASTIC_BATCH,
                                    shuffle=False),
                  batch_size=ELASTIC_BATCH, elastic=co, controller=ctl,
                  sharded_checkpoint_dir=f"{ELASTIC_DIR}/ctl",
                  comm_kernels=True, batch_end_callback=watch,
                  telemetry=ttel.TelemetryConfig(timeline=False,
                                                 memory=False))
    finally:
        faults.close()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    acted = [(d["lever"], d.get("rank"), d.get("mode"))
             for d in ctl.decisions if d["outcome"] == "actuated"]
    evicts = [r for lever, r, _ in acted if lever == "evict"]
    require(evicts == [CTL_STRAGGLER],
            f"controller: the straggler evicted once: {acted}")
    require(CTL_STRAGGLER not in co.alive and CTL_FLAKY in co.alive,
            f"controller: alive {co.alive}")
    require(CTL_FLAKY in [r for lever, r, _ in acted if lever == "backfill"],
            f"controller: the flaky rank backfilled: {acted}")
    tiers = [m for lever, _, m in acted if lever == "retier"]
    require(len(tiers) == 1 and tiers[0] in ("int8", "twobit")
            and ctl._comm_mode == tiers[0],
            f"controller: one retier to int8 or twobit: {acted}")
    tier = tiers[0]
    after = watch.by_key.get(tier, {})
    for name in (("quant_int8", "dequant_sum_int8", "dequant_int8")
                 if tier == "int8" else ("quant_twobit",
                                         "dequant_sum_twobit")):
        require(after.get(name, 0) > 0, f"controller: {name} launched "
                f"after the retier to {tier}: {after}")
    require(sum(g["fused_adam"] for g in watch.by_key.values()) > 0,
            "controller: fused_adam launched")
    require(ctl.breaker.state == CircuitBreaker.CLOSED,
            f"controller: the breaker {ctl.breaker.state}")
    dump = f"{ELASTIC_DIR}/flight.json"
    ttel.flight.dump(dump, reason="chip_smoke")
    ok, payload = ttel.validate_flight(dump)
    require(ok and "controller" in {e["kind"]
                                    for e in payload["incidents"]},
            "controller: the flight dump validates with controller "
            "incidents")
    require(fleet_threads() == [], f"controller: threads left after fit: "
            f"{fleet_threads()}")
    decisions = [(d["lever"], d["action"], d["outcome"])
                 for d in ctl.decisions]
    history = [dict(h, ranks=list(h["ranks"])) for h in co.history]
    applied = [e for e in ttel.hub().events(kind="controller")
               if e.get("lever") == "retier" and e.get("outcome")
               == "applied"]
    del model
    torch.cuda.empty_cache()

    # a tier the fit cannot apply, staged twice: frozen, not killed
    ttel.reset()
    co2 = ElasticCoordinator(ELASTIC_WORLD)
    ctl2 = FleetController(interval=0.0, window=8, min_report_steps=8,
                           auto_tier=False, auto_evict=False)
    staged = [0]

    def sabotage(_param):
        if staged[0] < 2:
            staged[0] += 1
            ctl2._pending_retier = {"mode": "bogus-tier"}

    m2 = elastic_model(mt, net, args, aux, ELASTIC_WORLD, 1)
    n = CTL_FREEZE_STEPS * ELASTIC_BATCH
    m2.fit(mt.io.NDArrayIter(X[:n], Y[:n], batch_size=ELASTIC_BATCH,
                             shuffle=False),
           batch_size=ELASTIC_BATCH, elastic=co2, controller=ctl2,
           sharded_checkpoint_dir=f"{ELASTIC_DIR}/freeze",
           batch_end_callback=sabotage)
    fails = [d["lever"] for d in ctl2.decisions if d["outcome"] == "failed"]
    require(fails == ["retier", "retier"] and ctl2.state == "frozen"
            and ctl2.breaker.state == CircuitBreaker.OPEN,
            f"controller: frozen after two failed retiers: {ctl2.decisions}")
    require(all(bool(torch.isfinite(v).all())
                for v in m2.arg_params.values()),
            "controller: the frozen fit finished with finite parameters")
    del m2
    torch.cuda.empty_cache()
    ttel.reset()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    emit({"phase": "controller", "model": "resnet50",
          "batch": ELASTIC_BATCH, "ctx": f"[gpu(0)] * {ELASTIC_WORLD}",
          "straggler": CTL_STRAGGLER, "flaky": CTL_FLAKY,
          "stall_s": CTL_STALL_S, "heartbeat_timeout_s": CTL_HEARTBEAT_S,
          "wire_gbps": wire_gbps, "ratio": CTL_RATIO,
          "decisions": decisions, "history": history,
          "downtime_s": [h["downtime_s"] for h in history],
          "retier": tier, "retier_s": [e.get("seconds") for e in applied],
          "launches": launches, "launches_by_tier": watch.by_key,
          "fit_s": fit_s, "freeze": {"failed": fails,
                                     "state": "frozen"},
          "card": nvidia_smi("name,power.limit")})
    return launches


MXLINT_LAUNCHES = 20        # fused_adam launches each timing fixture times
MXLINT_ROW_MS = 0.2714      # PERF.md §6 row 2: fused_adam at 161 leaves
MXLINT_FLOOR = 0.8          # the clean read is at least this share of rows
MXLINT_REPS = 3             # each timing fixture, in turns; the median kept
MXLINT_CLI_TIMEOUT_S = 300

# the timing fixture: the clock read after 20 launches, with or without a
# barrier before it (MX306)
MXLINT_TIMED = """import time

import torch


def timed(step, n):
    t0 = time.perf_counter()
    for _ in range(n):
        step()
{barrier}    return time.perf_counter() - t0
"""
# the capture fixture: a step given to CapturedProgram that reads a value
# back to the host, or returns the tensor (MX202)
MXLINT_CAPTURED = """from mxnet_tpu_torch.utils import compile as compile_mod


def make(x):
    def step():
        y = x * 2
        return {ret}
    return compile_mod.CapturedProgram(step, x.device, "mxlint_capture")
"""


def mxlint_fixtures():
    """The four fixture sources: (timed flagged, timed clean, captured
    flagged, captured clean)."""
    return (MXLINT_TIMED.format(barrier=""),
            MXLINT_TIMED.format(barrier="    torch.cuda.synchronize()\n"),
            MXLINT_CAPTURED.format(ret="y.sum().item()"),
            MXLINT_CAPTURED.format(ret="y.sum()"))


def mxlint_load(src, name):
    """The namespace of a fixture source, run as a module would be."""
    ns = {"__name__": name}
    exec(compile(src, name, "exec"), ns)  # noqa: S102 - the lint's fixture
    return ns


def mxlint_adam_program(torch, topt, compile_mod, kfa):
    """fused_adam's step at ResNet-50's 161 leaves (the Adam config of phase
    fused_adam), captured: each replay launches the kernel once, and the
    host's share of a launch is the replay's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    shapes = resnet50_leaf_shapes()
    names = list(shapes)
    opt = adam_configs(topt)["adam"](True)
    ws = [torch.randn(shapes[k], generator=gen, device="cuda")
          for k in names]
    gs = [torch.randn(shapes[k], generator=gen, device="cuda") * BATCH
          for k in names]
    states = opt.init_state_tree(dict(zip(names, ws)))
    ms = [states[k][0] for k in names]
    vs = [states[k][1] for k in names]
    _, scalars, hyper = opt._fused_args(names, states)
    scal = torch.from_numpy(kfa.step_vector(
        LEARNING_RATE, *scalars)).cuda()
    table = kfa.LeafTable()
    held = (ws, gs, ms, vs, scal, table)
    prog = compile_mod.CapturedProgram(
        lambda: kfa.fused_adam_step(*held[:5], table=table, **hyper),
        "cuda", "mxlint_adam", warmup=1)
    prog()          # the warm-up, eager: builds the leaf table
    prog.capture()
    torch.cuda.synchronize()
    return prog, held


def phase_mxlint(torch, mt, cli):
    """The linted source run on the card: the fixture the port's lint flags
    misbehaves there, its clean copy does not (MX306: a clock read without
    a barrier times the launches' enqueue; MX202: a host read inside a
    CUDA-graph capture makes the capture raise); then the result of the CLI
    over the port's tree with every pass (``cli``: phase card started it
    beside the builds, and it ran beside the phases after). Returns the
    timing fixtures' launches."""
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.analysis import lint_source
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.utils import compile as compile_mod

    t_start = time.perf_counter()
    timed_bad, timed_ok, cap_bad, cap_ok = mxlint_fixtures()
    lint = {name: [(f.rule.id, f.line) for f in lint_source(src, name)]
            for name, src in (("timed_flagged", timed_bad),
                              ("timed_clean", timed_ok),
                              ("captured_flagged", cap_bad),
                              ("captured_clean", cap_ok))}
    require([r for r, _ in lint["timed_flagged"]] == ["MX306"],
            f"mxlint: the unsynchronised delta is exactly MX306 "
            f"({lint['timed_flagged']})")
    require([r for r, _ in lint["captured_flagged"]] == ["MX202"],
            f"mxlint: the host read under capture is exactly MX202 "
            f"({lint['captured_flagged']})")
    require(lint["timed_clean"] == [] and lint["captured_clean"] == [],
            f"mxlint: the clean copies lint clean ({lint})")

    # (a) MX306: both copies time 20 launches of fused_adam, in turns
    prog, held = mxlint_adam_program(torch, topt, compile_mod, kfa)
    timers = {"flagged": mxlint_load(timed_bad, "mxlint_timed_flagged"),
              "clean": mxlint_load(timed_ok, "mxlint_timed_clean")}
    reset_launches()
    reads = {"flagged": [], "clean": []}
    for _ in range(MXLINT_REPS):
        for name, ns in timers.items():
            torch.cuda.synchronize()  # both start on an idle card
            reads[name].append(ns["timed"](prog, MXLINT_LAUNCHES) * 1e3)
            torch.cuda.synchronize()
    launches = read_launches()
    flagged_ms = statistics.median(reads["flagged"])
    clean_ms = statistics.median(reads["clean"])
    floor_ms = MXLINT_LAUNCHES * MXLINT_ROW_MS * MXLINT_FLOOR
    require(clean_ms >= floor_ms,
            f"mxlint: the synchronised read {clean_ms:.3f} ms covers "
            f"{MXLINT_LAUNCHES} launches ({floor_ms:.3f} ms at least)")
    require(flagged_ms <= 0.5 * clean_ms,
            f"mxlint: the flagged read {flagged_ms:.3f} ms is at most half "
            f"the synchronised one ({clean_ms:.3f} ms)")
    require(launches["fused_adam"] == 2 * MXLINT_REPS * MXLINT_LAUNCHES,
            f"mxlint: the timing fixtures launched fused_adam "
            f"{launches['fused_adam']} times")
    del prog, held, timers
    gc.collect()
    torch.cuda.empty_cache()

    # (b) MX202: the flagged step's capture raises; the clean one captures
    # and replays
    x = torch.arange(1024, dtype=torch.float32, device="cuda")
    want = float(2 * x.sum())
    bad = mxlint_load(cap_bad, "mxlint_captured_flagged")["make"](x)
    warm = bad()   # the warm-up runs eager, where a host read is allowed
    try:
        bad()
    except Exception as e:  # noqa: BLE001 - which error the capture raises
        raised = f"{type(e).__name__}: {e}"
    else:
        raised = None
    require(raised is not None and not bad.captured,
            "mxlint: the capture of the MX202 step raised")
    torch.cuda.synchronize()
    good = mxlint_load(cap_ok, "mxlint_captured_clean")["make"](x)
    outs = [float(good()) for _ in range(3)]  # warm-up, capture, replay
    require(good.captured and outs == [want] * 3 and warm == want,
            f"mxlint: the clean step captured and replayed {outs} "
            f"(want {want})")

    # (c) the CLI over the port's tree, every pass, on this machine
    returncode, stdout, stderr, cli_s = cli
    summary = stdout.strip().splitlines()[-1] if stdout else ""
    require(returncode == 0 and ": 0 error(s)" in summary
            and "(0 findings)" in stdout,
            f"mxlint: the CLI exits 0 over the port ({returncode}: "
            f"{stdout[-1500:]} {stderr[-1500:]})")
    files = int(summary.split("checked ")[1].split()[0])
    emit({"phase": "mxlint", "lint": lint,
          "timed": {"launches": MXLINT_LAUNCHES, "flagged_ms": flagged_ms,
                    "clean_ms": clean_ms, "floor_ms": floor_ms,
                    "flagged_reads_ms": reads["flagged"],
                    "clean_reads_ms": reads["clean"],
                    "row_ms": MXLINT_ROW_MS},
          "captured": {"flagged_capture_raised": raised[:300],
                       "clean_outputs": outs},
          "cli": {"argv": "--all", "seconds": cli_s, "files": files,
                  "summary": summary, "ran": "from phase card, beside the "
                  "builds and the phases after"},
          "phase_s": time.perf_counter() - t_start,
          "launches": launches})
    return launches


# -- 12b. bindings: the flat C API on the card, an embedded C host, and the
# native predictor on the card's host ------------------------------------------
CAPI_STEPS = 3              # ResNet-50 training steps through the C API
CAPI_LR = 0.05              # SGD through MXFuncInvoke: w -= lr / batch * g
CAPI_BOUND = 1e-6           # relative Frobenius, C API against Executor
CAPI_MLP_SEED = 0
CAPI_MLP_STEPS = 20         # tests/torch_capi_host.cc's SGD steps
CAPI_MLP_ROWS, CAPI_MLP_BATCH = 40, 8
CAPI_MLP_LR, CAPI_MLP_SD = 0.5, 0.3
CAPI_HOST_TIMEOUT_S = 180
CAPI_HOST = "tests/torch_capi_host.cc"
PREDICT_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_native_predict.py's
PREDICT_REQUESTS = 1
BINDINGS_DIR = "build/chip_smoke/bindings"
BINDINGS_BUDGET_S = 120


def capi_load(path):
    """The C API library at ``path`` through ctypes (hosted: it joins this
    interpreter), with the argument types of the functions the helpers
    below call (mxtpu_c_api.h)."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    lib.MXGetLastError.restype = ctypes.c_char_p
    u, i, vp = ctypes.c_uint, ctypes.c_int, ctypes.c_void_p
    pu, pi, pvp = (ctypes.POINTER(t) for t in (u, i, vp))
    pf = ctypes.POINTER(ctypes.c_float)
    for name, argtypes in (
            ("MXRandomSeed", [i]),
            ("MXNDArrayCreate", [pu, u, i, i, i, pvp]),
            ("MXNDArraySyncCopyFromCPU", [vp, pf, ctypes.c_size_t]),
            ("MXNDArraySyncCopyToCPU", [vp, pf, ctypes.c_size_t]),
            ("MXNDArrayGetShape", [vp, pu, ctypes.POINTER(pu)]),
            ("MXNDArrayGetContext", [vp, pi, pi]),
            ("MXNDArrayFree", [vp]),
            ("MXGetFunction", [ctypes.c_char_p, pvp]),
            ("MXFuncInvoke", [vp, pvp, pf, pvp]),
            ("MXSymbolCreateFromJSON", [ctypes.c_char_p, pvp]),
            ("MXExecutorBind", [vp, i, i, u, pvp, pvp, pu, u, pvp, pvp]),
            ("MXExecutorForward", [vp, i]),
            ("MXExecutorBackward", [vp, u, pvp]),
            ("MXExecutorOutputs", [vp, pu, ctypes.POINTER(pvp)]),
            ("MXExecutorFree", [vp])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, i
    return lib


def capi_check(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: {lib.MXGetLastError().decode()}")


def capi_array(lib, shape, dev_type, values=None):
    """A new NDArrayHandle of ``shape`` on ``dev_type``, filled from the f32
    numpy array ``values`` when given."""
    import ctypes

    h = ctypes.c_void_p()
    capi_check(lib, lib.MXNDArrayCreate(
        (ctypes.c_uint * len(shape))(*shape), len(shape), dev_type, 0, 0,
        ctypes.byref(h)), "MXNDArrayCreate")
    if values is not None:
        capi_copy_in(lib, h, values)
    return h


def capi_copy_in(lib, h, values):
    import ctypes

    values = np.ascontiguousarray(values, np.float32)
    capi_check(lib, lib.MXNDArraySyncCopyFromCPU(
        h, values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_size_t(values.size)), "MXNDArraySyncCopyFromCPU")


def capi_read(lib, h):
    """An NDArrayHandle's value through MXNDArrayGetShape and
    MXNDArraySyncCopyToCPU."""
    import ctypes

    ndim, pdata = ctypes.c_uint(), ctypes.POINTER(ctypes.c_uint)()
    capi_check(lib, lib.MXNDArrayGetShape(h, ctypes.byref(ndim),
                                          ctypes.byref(pdata)),
               "MXNDArrayGetShape")
    out = np.empty(tuple(pdata[i] for i in range(ndim.value)), np.float32)
    capi_check(lib, lib.MXNDArraySyncCopyToCPU(
        h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_size_t(out.size)), "MXNDArraySyncCopyToCPU")
    return out


def capi_context(lib, h):
    import ctypes

    dt, di = ctypes.c_int(), ctypes.c_int()
    capi_check(lib, lib.MXNDArrayGetContext(h, ctypes.byref(dt),
                                            ctypes.byref(di)),
               "MXNDArrayGetContext")
    return dt.value, di.value


def capi_function(lib, name):
    import ctypes

    f = ctypes.c_void_p()
    capi_check(lib, lib.MXGetFunction(name.encode(), ctypes.byref(f)),
               "MXGetFunction")
    return f


def capi_invoke(lib, fn, use, scalars, mutate):
    import ctypes

    capi_check(lib, lib.MXFuncInvoke(
        fn, (ctypes.c_void_p * max(1, len(use)))(*use),
        (ctypes.c_float * max(1, len(scalars)))(*scalars),
        (ctypes.c_void_p * len(mutate))(*mutate)), "MXFuncInvoke")


def capi_bind(lib, sym, dev_type, args, grads, reqs, aux=()):
    import ctypes

    n = len(args)
    h = ctypes.c_void_p()
    capi_check(lib, lib.MXExecutorBind(
        sym, dev_type, 0, n, (ctypes.c_void_p * n)(*args),
        (ctypes.c_void_p * n)(*grads), (ctypes.c_uint * n)(*reqs), len(aux),
        (ctypes.c_void_p * max(1, len(aux)))(*aux), ctypes.byref(h)),
        "MXExecutorBind")
    return h


def capi_outputs(lib, ex):
    import ctypes

    n, outs = ctypes.c_uint(), ctypes.POINTER(ctypes.c_void_p)()
    capi_check(lib, lib.MXExecutorOutputs(ex, ctypes.byref(n),
                                          ctypes.byref(outs)),
               "MXExecutorOutputs")
    return [ctypes.c_void_p(outs[i]) for i in range(n.value)]


def capi_free(lib, *handles):
    for h in handles:
        capi_check(lib, lib.MXNDArrayFree(h), "MXNDArrayFree")


def capi_mlp_symbol(lib):
    """tests/test_c_api.py's MLP through CreateAtomicSymbol + Compose, as
    tests/torch_capi_host.cc builds it."""
    import ctypes

    n, creators = ctypes.c_uint(), ctypes.POINTER(ctypes.c_void_p)()
    capi_check(lib, lib.MXSymbolListAtomicSymbolCreators(
        ctypes.byref(n), ctypes.byref(creators)), "ListAtomicSymbolCreators")
    by_name = {}
    for i in range(n.value):
        c = ctypes.c_void_p(creators[i])
        name, desc, kv = (ctypes.c_char_p() for _ in range(3))
        nargs = ctypes.c_uint()
        an, at, ad = (ctypes.POINTER(ctypes.c_char_p)() for _ in range(3))
        capi_check(lib, lib.MXSymbolGetAtomicSymbolInfo(
            c, ctypes.byref(name), ctypes.byref(desc), ctypes.byref(nargs),
            ctypes.byref(an), ctypes.byref(at), ctypes.byref(ad),
            ctypes.byref(kv)), "GetAtomicSymbolInfo")
        by_name[name.value.decode()] = c

    def layer(op, name, inp, **params):
        s = ctypes.c_void_p()
        keys = (ctypes.c_char_p * max(1, len(params)))(
            *[k.encode() for k in params])
        vals = (ctypes.c_char_p * max(1, len(params)))(
            *[str(v).encode() for v in params.values()])
        capi_check(lib, lib.MXSymbolCreateAtomicSymbol(
            by_name[op], len(params), keys, vals, ctypes.byref(s)),
            "CreateAtomicSymbol")
        capi_check(lib, lib.MXSymbolCompose(
            s, name.encode(), 1, (ctypes.c_char_p * 1)(b"data"),
            (ctypes.c_void_p * 1)(inp)), "Compose")
        return s

    data = ctypes.c_void_p()
    capi_check(lib, lib.MXSymbolCreateVariable(b"data", ctypes.byref(data)),
               "CreateVariable")
    net = layer("FullyConnected", "fc1", data, num_hidden=4)
    net = layer("Activation", "relu1", net, act_type="relu")
    net = layer("FullyConnected", "fc2", net, num_hidden=2)
    return layer("SoftmaxOutput", "softmax", net)


def capi_mlp_rows(step):
    """The host's batch of a step: rows of eighths and their labels."""
    r = (step * CAPI_MLP_BATCH + np.arange(CAPI_MLP_BATCH)) % CAPI_MLP_ROWS
    x = (((r[:, None] * 7 + np.arange(3) * 13 + 5) % 17 - 8) / 8.0
         ).astype(np.float32)
    y = (x[:, 0] + x[:, 1] - x[:, 2] > 0).astype(np.float32)
    return x, y


def capi_mlp(lib, dev_type, steps, seed=CAPI_MLP_SEED, init=None):
    """tests/torch_capi_host.cc's sequence through ``lib`` from this
    process: MXRandomSeed(seed), the MLP on ``dev_type``, weights drawn by
    ``_random_gaussian`` (or copied from ``init``, a list of the four
    parameters' arrays), then ``steps`` SGD steps through MXFuncInvoke.
    Returns each step's mean cross-entropy, computed as the host computes
    it (in double, rows in order)."""
    import math

    capi_check(lib, lib.MXRandomSeed(seed), "MXRandomSeed")
    sym = capi_mlp_symbol(lib)
    shapes = [(CAPI_MLP_BATCH, 3), (4, 3), (4,), (2, 4), (2,),
              (CAPI_MLP_BATCH,)]
    gaussian, set_value = (capi_function(lib, n)
                           for n in ("_random_gaussian", "_set_value"))
    args, grads = [], []
    for i, shape in enumerate(shapes):
        args.append(capi_array(lib, shape, dev_type))
        param = 0 < i < len(shapes) - 1
        grads.append(capi_array(lib, shape, dev_type) if param else None)
        if not param:
            continue
        if init is not None:
            capi_copy_in(lib, args[i], init[i - 1])
        elif i in (1, 3):
            capi_invoke(lib, gaussian, [], [0.0, CAPI_MLP_SD], [args[i]])
        else:
            capi_invoke(lib, set_value, [], [0.0], [args[i]])
    ex = capi_bind(lib, sym, dev_type, args, grads,
                   [1 if g is not None else 0 for g in grads])
    mul_scalar, minus = (capi_function(lib, n)
                         for n in ("_mul_scalar", "_minus"))
    scratch = [capi_array(lib, s, dev_type) for s in shapes]
    losses = []
    for step in range(steps):
        x, y = capi_mlp_rows(step)
        capi_copy_in(lib, args[0], x)
        capi_copy_in(lib, args[-1], y)
        capi_check(lib, lib.MXExecutorForward(ex, 1), "MXExecutorForward")
        outs = capi_outputs(lib, ex)
        prob = capi_read(lib, outs[0])
        capi_free(lib, *outs)
        loss = 0.0
        for b in range(CAPI_MLP_BATCH):
            loss -= math.log(float(prob[b, int(y[b])]))
        losses.append(loss / CAPI_MLP_BATCH)
        capi_check(lib, lib.MXExecutorBackward(ex, 0, None),
                   "MXExecutorBackward")
        for i in range(1, len(shapes) - 1):
            capi_invoke(lib, mul_scalar, [grads[i]],
                        [CAPI_MLP_LR / CAPI_MLP_BATCH], [scratch[i]])
            capi_invoke(lib, minus, [args[i], scratch[i]], [], [args[i]])
    return losses


def capi_host_build(lib_path, out):
    """tests/torch_capi_host.cc linked against the C API library at
    ``lib_path``; returns the program's path."""
    import os

    from mxnet_tpu_torch.native import capi

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall",
         os.path.join(root, CAPI_HOST), "-o", str(out),
         "-I" + str(capi.HEADER.parent), f"-L{lib_path.parent}",
         "-lmxtpu_torch_capi", f"-Wl,-rpath,{lib_path.parent}"],
        capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0,
            f"bindings: the embedded host builds ({proc.stderr[-1500:]})")
    return out


def capi_host_run(host, dev_type, steps, timeout_s=CAPI_HOST_TIMEOUT_S):
    """(exit code, losses, seconds, stderr) of the embedded host."""
    from mxnet_tpu_torch.native import capi

    t0 = time.perf_counter()
    proc = subprocess.run([str(host), str(dev_type), str(CAPI_MLP_SEED),
                           str(steps)], capture_output=True, text=True,
                          timeout=timeout_s, env=capi.embedding_env())
    losses = [float(line.split()[2]) for line in proc.stdout.splitlines()
              if line.startswith("loss ")]
    return proc.returncode, losses, time.perf_counter() - t0, proc.stderr


def bindings_builds(tmp):
    """Every library of the phase, built in parallel: the C API (then the
    embedded host against it), the native predictor, and the amalgamated
    predictor. Returns their paths and each build's seconds."""
    from mxnet_tpu_torch.bindings import amalgamation
    from mxnet_tpu_torch.native import capi
    from mxnet_tpu_torch.native import predict as npredict

    tmp.mkdir(parents=True, exist_ok=True)

    def timed_call(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    def capi_and_host():
        lib_path = capi.build_capi()
        return lib_path, capi_host_build(lib_path, tmp / "torch_capi_host")

    def amalgamated():
        src = amalgamation.amalgamate(output=str(tmp / "mxtpu_predict-all.cc"))
        return amalgamation.compile_check(src)

    with ThreadPoolExecutor(3) as pool:
        jobs = {"capi": pool.submit(timed_call, capi_and_host),
                "predict": pool.submit(timed_call, npredict.get_predict_lib),
                "amalgamation": pool.submit(timed_call, amalgamated)}
        got = {k: j.result() for k, j in jobs.items()}
    require(got["predict"][0] is not None,
            f"bindings: the native predictor builds ({npredict._error})")
    (lib_path, host), _ = got["capi"]
    return (lib_path, host, got["amalgamation"][0],
            {k: v[1] for k, v in got.items()})


def capi_resnet_run(torch, mt, lib, net, args, aux, batches, fault=None):
    """ResNet-50 through the C API on the card: the symbol from JSON, every
    argument made with MXNDArrayCreate(dev_type=2) and
    MXNDArraySyncCopyFromCPU, MXExecutorBind(dev_type=2) with each
    parameter's gradient written, then per batch MXExecutorForward(1),
    MXExecutorBackward and SGD through MXFuncInvoke. Returns each step's
    outputs and gradients (MXNDArraySyncCopyToCPU), host ms a step and the
    contexts of an argument and an output. ``fault``: ("ulp", name) binds
    that argument one ulp up at its first element; "stale" drops the copy
    of rebound handles into the executor."""
    import ctypes

    from mxnet_tpu_torch import capi_support

    sym = ctypes.c_void_p()
    capi_check(lib, lib.MXSymbolCreateFromJSON(net.tojson().encode(),
                                               ctypes.byref(sym)),
               "MXSymbolCreateFromJSON")
    names = net.list_arguments()
    args = dict(args)
    if fault is not None and fault[0] == "ulp":
        w = args[fault[1]].copy()
        w.flat[0] = np.nextafter(w.flat[0], np.float32(np.inf))
        args[fault[1]] = w
    first_x, first_y = batches[0]
    handles, grads = [], []
    for n in names:
        value = {"data": first_x, "softmax_label": first_y}.get(n, args.get(n))
        handles.append(capi_array(lib, value.shape, 2, value))
        grads.append(capi_array(lib, value.shape, 2) if n in args else None)
    aux_h = [capi_array(lib, aux[n].shape, 2, aux[n])
             for n in net.list_auxiliary_states()]
    saved = capi_support._BoundExecutor._sync_in
    if fault == "stale":
        capi_support._BoundExecutor._sync_in = lambda self: None
    try:
        ex = capi_bind(lib, sym, 2, handles, grads,
                       [1 if g is not None else 0 for g in grads], aux_h)
        mul_scalar, minus = (capi_function(lib, n)
                             for n in ("_mul_scalar", "_minus"))
        scratch = {i: capi_array(lib, args[n].shape, 2)
                   for i, n in enumerate(names) if n in args}
        scale = float(np.float32(CAPI_LR / BATCH))
        steps, step_ms = [], []
        for x, y in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            capi_copy_in(lib, handles[names.index("data")], x)
            capi_copy_in(lib, handles[names.index("softmax_label")], y)
            capi_check(lib, lib.MXExecutorForward(ex, 1), "Forward")
            capi_check(lib, lib.MXExecutorBackward(ex, 0, None), "Backward")
            outs = capi_outputs(lib, ex)
            got = {"out": capi_read(lib, outs[0]),
                   "grads": {n: capi_read(lib, grads[i])
                             for i, n in enumerate(names) if n in args}}
            for i in scratch:
                capi_invoke(lib, mul_scalar, [grads[i]], [scale],
                            [scratch[i]])
                capi_invoke(lib, minus, [handles[i], scratch[i]], [],
                            [handles[i]])
            capi_check(lib, lib.MXNDArrayWaitAll(), "MXNDArrayWaitAll")
            step_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(got)
        contexts = {"argument": capi_context(lib, handles[0]),
                    "output": capi_context(lib, outs[0])}
        capi_free(lib, *outs, *handles, *aux_h, *scratch.values(),
                  *[g for g in grads if g is not None])
        capi_check(lib, lib.MXExecutorFree(ex), "MXExecutorFree")
    finally:
        capi_support._BoundExecutor._sync_in = saved
    return steps, step_ms, contexts


def python_resnet_run(torch, mt, net, args, aux, batches):
    """The same steps through the port's Python ``Executor`` on gpu(0):
    the batch copied in, forward, backward, and the same SGD through the
    NDArray functions MXFuncInvoke calls."""
    from mxnet_tpu_torch import ndarray as nd

    ctx = mt.gpu(0)
    first_x, first_y = batches[0]
    values = {n: nd.array(np.array({"data": first_x, "softmax_label": first_y}
                                   .get(n, args.get(n))), ctx)
              for n in net.list_arguments()}
    grads = {n: nd.zeros(args[n].shape, ctx) for n in args}
    ex = net.bind(ctx, {n: v.data for n, v in values.items()},
                  args_grad={n: g.data for n, g in grads.items()},
                  grad_req={n: "write" if n in args else "null"
                            for n in net.list_arguments()},
                  aux_states={n: torch.from_numpy(v.copy()).cuda()
                              for n, v in aux.items()})
    scale = float(np.float32(CAPI_LR / BATCH))
    steps, step_ms = [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.arg_dict["data"].copy_(torch.from_numpy(x).cuda())
        ex.arg_dict["softmax_label"].copy_(torch.from_numpy(y).cuda())
        out = ex.forward(is_train=True)[0]
        ex.backward()
        got = {"out": out.cpu().numpy().copy(),  # a copy on a CPU rehearsal
               "grads": {n: ex.grad_dict[n].cpu().numpy().copy()
                         for n in args}}
        for n in args:
            w = nd.NDArray(ex.arg_dict[n], ctx)
            step = nd._mul_scalar(nd.NDArray(ex.grad_dict[n], ctx), scale)
            ex.arg_dict[n].copy_(nd._minus(w, step).data)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(got)
    return steps, step_ms


def capi_errors(steps, ref):
    """(the largest relative Frobenius error of a step's output or of its
    gradients taken together, the largest absolute error, whether every
    array is bitwise equal) over the steps."""
    worst, worst_abs, bitwise = 0.0, 0.0, True
    for got, want in zip(steps, ref):
        names = sorted(want["grads"])
        for a, b in ((got["out"], want["out"]),
                     (np.concatenate([got["grads"][n].ravel() for n in names]),
                      np.concatenate([want["grads"][n].ravel()
                                      for n in names]))):
            bitwise &= bool(np.array_equal(a, b))
            worst = max(worst, rel_fro(a, b))
            worst_abs = max(worst_abs, float(np.abs(a - b).max()))
    return worst, worst_abs, bitwise


def capi_kvstore_on_card(lib):
    """A local KVStore with a C updater over card arrays: the updater calls
    back into MX* functions (the GIL taken again while held)."""
    import ctypes

    updater_t = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p)
    calls = []

    @updater_t
    def sgd(key, recv, local, _):
        recv, local = ctypes.c_void_p(recv), ctypes.c_void_p(local)
        calls.append((key, capi_context(lib, recv), capi_context(lib, local)))
        capi_copy_in(lib, local, capi_read(lib, local)
                     - np.float32(0.1) * capi_read(lib, recv))

    kv = ctypes.c_void_p()
    capi_check(lib, lib.MXKVStoreCreate(b"local", ctypes.byref(kv)),
               "MXKVStoreCreate")
    capi_check(lib, lib.MXKVStoreSetUpdater(kv, sgd, None), "SetUpdater")
    keys = (ctypes.c_int * 1)(3)
    w = capi_array(lib, (4,), 2, np.ones(4, np.float32))
    capi_check(lib, lib.MXKVStoreInit(kv, 1, keys, (ctypes.c_void_p * 1)(w)),
               "MXKVStoreInit")
    g = capi_array(lib, (4,), 2, np.full(4, 2.0, np.float32))
    capi_check(lib, lib.MXKVStorePush(kv, 1, keys, (ctypes.c_void_p * 1)(g),
                                      0), "MXKVStorePush")
    out = capi_array(lib, (4,), 2)
    capi_check(lib, lib.MXKVStorePull(kv, 1, keys,
                                      (ctypes.c_void_p * 1)(out), 0),
               "MXKVStorePull")
    pulled = capi_read(lib, out)
    ctx = capi_context(lib, out)
    capi_free(lib, w, g, out)
    capi_check(lib, lib.MXKVStoreFree(kv), "MXKVStoreFree")
    del sgd
    return calls, pulled, ctx


def native_predictions(bundle, amalgamated_so, x, requests):
    """The bundle through the port's NativePredictor, the amalgamated
    build and the standalone module: {route: (output, host ms each)}."""
    import importlib.util
    import os

    from mxnet_tpu_torch.native import predict as npredict

    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_standalone_predict",
        os.path.join(root, "mxnet_tpu_torch", "bindings", "mxtpu_predict.py"))
    standalone = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(standalone)

    def through(pred, run):
        ms, out = [], None
        for _ in range(requests):
            t0 = time.perf_counter()
            out = run(pred)
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    def native(pred):
        pred.forward(data=x)
        return pred.get_output(0)

    return {
        "native": through(npredict.NativePredictor(bundle), native),
        "amalgamated": through(npredict.NativePredictor(
            bundle, lib=npredict.load_lib(amalgamated_so)), native),
        "standalone": through(standalone.Predictor(bundle),
                              lambda p: p.predict({"data": x})[0])}


def phase_bindings(torch, mt, built):
    """12b. The bindings: (a) ResNet-50 at batch 32 trained 3 steps through
    the flat C API on the card (ctypes, the library hosted in this
    process), held to the Python ``Executor`` on gpu(0) with the same
    arguments (TF32 off, cuDNN deterministic): bitwise expected, gated at
    CAPI_BOUND; MXNDArrayGetContext (2, 0); a stale-handle fault above the
    bound and a one-ulp one not bitwise; a KVStore whose C updater calls
    back into MX* on card arrays. (b) tests/torch_capi_host.cc, an embedded
    C host, trains the MLP on dev_type 2: exit 0, a falling loss, its first
    loss equal to the same sequence run hosted here. (c) ResNet-50 at batch
    1 exported by the port's Predictor on the card and run on this
    machine's CPU through NativePredictor, the amalgamated build and the
    standalone module: bitwise equal to each other, within PREDICT_TOL of
    the card's output. Returns the kernels' launches across (a)-(c)."""
    from pathlib import Path

    from mxnet_tpu_torch.native import capi

    t_start = time.perf_counter()
    tmp = Path(BINDINGS_DIR)
    # built in phase card, beside the kernels (bindings_builds)
    lib_path, host, amalgamated_so, build_s = built
    lib = capi_load(lib_path)
    reset_launches()

    # (a) the C API on the card
    net, args, aux, batch_x, batch_y = resnet50_case()
    rng = np.random.default_rng(SEED + 23)
    batches = [(batch_x, batch_y)] + [
        (rng.standard_normal(batch_x.shape, np.float32),
         rng.integers(0, 1000, BATCH).astype(np.float32))
        for _ in range(CAPI_STEPS - 1)]
    with cudnn_deterministic(torch):
        c_steps, c_ms, contexts = capi_resnet_run(torch, mt, lib, net, args,
                                                  aux, batches)
        py_steps, py_ms = python_resnet_run(torch, mt, net, args, aux,
                                            batches)
        err, err_abs, bitwise = capi_errors(c_steps, py_steps)
        stale_err = capi_errors(capi_resnet_run(
            torch, mt, lib, net, args, aux, batches, fault="stale")[0],
            py_steps)[0]
        ulp_name = next(n for n in net.list_arguments() if n in args)
        ulp_err, _, ulp_bitwise = capi_errors(capi_resnet_run(
            torch, mt, lib, net, args, aux, batches,
            fault=("ulp", ulp_name))[0], py_steps)
    n_grads = len(c_steps[0]["grads"])
    require(err <= CAPI_BOUND,
            f"bindings: the C API's ResNet-50 steps read {err:.3e} against "
            f"the Executor's (bound {CAPI_BOUND})")
    require(stale_err > CAPI_BOUND,
            f"bindings: the stale-handle fault reads {stale_err:.3e}, above "
            f"{CAPI_BOUND}")
    require(not ulp_bitwise,
            f"bindings: a one-ulp change of {ulp_name} is not bitwise equal")
    require(contexts == {"argument": (2, 0), "output": (2, 0)},
            f"bindings: MXNDArrayGetContext reads {contexts}")
    kv_calls, kv_pulled, kv_ctx = capi_kvstore_on_card(lib)
    require(kv_calls == [(3, (2, 0), (2, 0))] and kv_ctx == (2, 0)
            and np.array_equal(kv_pulled,
                               np.full(4, np.float32(1) - np.float32(0.1)
                                       * np.float32(2), np.float32)),
            f"bindings: the C updater ran on card arrays ({kv_calls}, "
            f"{kv_pulled}, {kv_ctx})")
    del c_steps, py_steps

    # (b) the embedded C host on the card, and its sequence hosted here under
    # the package's default precision, which the host's fresh process has
    # (TF32 on)
    precision = mt.get_matmul_precision()
    mt.set_matmul_precision("default")
    try:
        hosted = capi_mlp(lib, 2, CAPI_MLP_STEPS)
    finally:
        mt.set_matmul_precision(precision)
    rc, host_losses, host_s, host_err = capi_host_run(host, 2, CAPI_MLP_STEPS)
    require(rc == 0 and len(host_losses) == CAPI_MLP_STEPS,
            f"bindings: the embedded host exits 0 with {CAPI_MLP_STEPS} "
            f"losses (exit {rc}: {host_err[-1500:]})")
    require(host_losses[-1] < host_losses[0],
            f"bindings: the embedded host's loss falls ({host_losses})")
    require(host_losses[0] == hosted[0],
            f"bindings: the embedded host's first loss {host_losses[0]!r} "
            f"equals the hosted sequence's {hosted[0]!r}")

    # (c) the native predictor over a bundle the card's Predictor exported
    x1 = batch_x[:1]
    pred = mt.Predictor(net, args, aux, ctx=mt.gpu(0), input_names=["data"])
    pred.forward(data=x1)
    card_out = pred.get_output(0)
    bundle = str(tmp / "resnet50_b1.mxtpu")
    t0 = time.perf_counter()
    pred.export(bundle)
    export_s = time.perf_counter() - t0
    routes = native_predictions(bundle, amalgamated_so, x1, PREDICT_REQUESTS)
    outs = {k: v[0] for k, v in routes.items()}
    require(all(np.array_equal(outs["native"], o) for o in outs.values()),
            "bindings: the three native predictor builds are bitwise equal")
    require(outs["native"].shape == card_out.shape and np.allclose(
        outs["native"], card_out, **PREDICT_TOL),
        f"bindings: the native predictor is within {PREDICT_TOL} of the "
        f"card ({np.abs(outs['native'] - card_out).max():.3e})")
    launches = read_launches()
    require(not any(launches.values()),
            f"bindings: no hand-written kernel launched ({launches})")
    phase_s = time.perf_counter() - t_start
    emit({"phase": "bindings", "python": sys.version.split()[0],
          "py_enable_shared": capi._python_flags()[1] != (),
          "build_s": build_s,
          "capi": {"model": "resnet50", "batch": BATCH, "steps": CAPI_STEPS,
                   "grads": n_grads, "max_rel_fro": err,
                   "max_abs_err": err_abs, "bitwise": bitwise,
                   "bound": CAPI_BOUND, "stale_fault_rel_fro": stale_err,
                   "ulp_fault": {"arg": ulp_name, "rel_fro": ulp_err},
                   "contexts": contexts, "capi_step_host_ms": c_ms,
                   "python_step_host_ms": py_ms,
                   "kvstore_updater_calls": kv_calls},
          "host": {"exit": rc, "seconds": host_s, "losses": host_losses,
                   "hosted_losses": hosted,
                   "equal_steps": sum(a == b for a, b in
                                      zip(host_losses, hosted))},
          "predict": {"model": "resnet50", "batch": 1, "export_s": export_s,
                      "max_abs_err": float(np.abs(outs["native"]
                                                  - card_out).max()),
                      "host_cpu_ms_per_request": {
                          k: v[1] for k, v in routes.items()}},
          "phase_s": phase_s, "budget_s": BINDINGS_BUDGET_S,
          "launches": launches})
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- slice 24: the tools and the launched examples ----------------------------

TOOLS_DIR = "build/chip_smoke/tools"
TOOLS_BUDGET_S = 100
TOOLS_LAUNCH_TIMEOUT_S = 240
TOOLS_IM2REC_TIMEOUT_S = 180
# the launched tier: the launcher, two workers sharing the card
TOOLS_LAUNCH_WORKERS = 2
TOOLS_MLP_ACCURACY = 0.95   # dist_sync_mlp.py's own assertion
# im2rec: 64 seeded PNG sources (the port's encoder), 4 classes a folder,
# packed with --resize 40 --center-crop
TOOLS_IMAGES = 64
TOOLS_CLASSES = 4
TOOLS_RESIZE = 40
# sha256 of the .rec that the JAX package's tools/im2rec.py writes from
# tools_images() with --resize 40 --center-crop (PIL 12.1.0's JPEG encoder;
# tests/test_torch_tools.py asserts it against that script)
TOOLS_REC_SHA256 = ("52da705d6fee17c332cebc96990e0189"
                    "ca660445014f747194b3f2875190222c")
# elastic_train.py's membership history, as the JAX script prints it
ELASTIC_EXAMPLE_HISTORY = [(8, 6, "kill:7:failure;kill:6:failure"),
                           (6, 8, "join:6:rejoin;join:7:rejoin")]
ELASTIC_EXAMPLE_ACCURACY = 0.95  # this phase's gate; the script asserts none
# train_long_lm.py at dp 2 x sp 2 with the flash kernels, its defaults
# otherwise: 600 steps, 2 layers, d_model 64 over 4 heads, seq 128
LONGLM_DP, LONGLM_SP = 2, 2
LONGLM_STEPS = 600
LONGLM_LAYERS = 2
LONGLM_TIMEOUT_S = 300
LONGLM_LOSS_BOUND = 1.5     # the script's own assertion
# the flash kernels at the example's rank-local shape: (batch per dp rank,
# heads, seq per sp rank, head_dim), f32
LONGLM_FLASH_SHAPE = (2, 4, 64, 16)
# the converted LeNet on the card against the CPU, TF32 off, max abs
CAFFE_BOUND = 1e-5
# tests/test_caffe_converter.py's LeNet prototxt
CAFFE_LENET = """
name: "LeNet"
input: "data"
input_dim: 2
input_dim: 1
input_dim: 28
input_dim: 28
layer {
  name: "conv1"
  type: "Convolution"
  bottom: "data"
  top: "conv1"
  convolution_param { num_output: 8 kernel_size: 5 stride: 1 }
}
layer {
  name: "relu1"
  type: "ReLU"
  bottom: "conv1"
  top: "conv1"
}
layer {
  name: "pool1"
  type: "Pooling"
  bottom: "conv1"
  top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 }
}
layer {
  name: "ip1"
  type: "InnerProduct"
  bottom: "pool1"
  top: "ip1"
  inner_product_param { num_output: 10 }
}
layer {
  name: "prob"
  type: "Softmax"
  bottom: "ip1"
  top: "prob"
}
"""
# a launched worker: the example's module as `python -m` runs it, then the
# card bytes the worker held at its peak (0 for a worker that stayed off
# the card), in a file of its own: the workers share one stdout, where one
# worker's line can land inside the other's
TOOLS_WORKER = (
    "import os, runpy, sys\n"
    "sys.argv = ['{module}']\n"
    "runpy.run_module('{module}', run_name='__main__', alter_sys=True)\n"
    "import torch\n"
    "rank = os.environ['MXTPU_WORKER_RANK']\n"
    "with open(os.path.join({out_dir!r}, 'card_peak_bytes.' + rank), "
    "'w') as f:\n"
    "    f.write(str(torch.cuda.max_memory_allocated()))\n")


def tools_images():
    """The im2rec sources: ``(relative path, HWC uint8)`` for 64 smooth
    images of 44-96 pixels a side, 16 a class folder."""
    rng = np.random.default_rng(SEED + 24)
    out = []
    for i in range(TOOLS_IMAGES):
        h, w = (int(v) for v in rng.integers(44, 97, 2))
        out.append((f"class{i % TOOLS_CLASSES}/img{i:02d}.png",
                    io_image(rng, h, w)))
    return out


def write_tool_images(root):
    """Write :func:`tools_images` under ``root`` as PNG (the port's
    encoder)."""
    from pathlib import Path

    from mxnet_tpu_torch.io import _imaging

    for rel, img in tools_images():
        path = Path(root) / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(_imaging.png_encode(img))


def caffe_blobs():
    """tests/test_caffe_converter.py's seeded LeNet blobs."""
    rng = np.random.RandomState(0)
    return {"conv1": [rng.randn(8, 1, 5, 5).astype(np.float32),
                      rng.randn(8).astype(np.float32)],
            "ip1": [rng.randn(10, 8 * 12 * 12).astype(np.float32),
                    rng.randn(10).astype(np.float32)]}


def start_tools_launch(out_dir):
    """(a)'s command: ``tools/launch.py -n 2`` running
    ``mxnet_tpu_torch.examples.distributed.dist_sync_mlp`` on the card in
    each worker (no ``--cpu``), each worker writing its peak card bytes
    to a file of its own after the script."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    module = "mxnet_tpu_torch.examples.distributed.dist_sync_mlp"
    out_dir = os.path.abspath(out_dir)
    return start_logged(
        [sys.executable, os.path.join(repo, "tools", "launch.py"), "-n",
         str(TOOLS_LAUNCH_WORKERS), sys.executable, "-c",
         TOOLS_WORKER.format(module=module, out_dir=out_dir)], out_dir,
        "launch", cwd=repo)


def start_tools_im2rec(out_dir):
    """(d)'s command: the 64 sources written, listed with ``--make-list``
    and packed by ``python -m mxnet_tpu_torch.tools.im2rec --resize 40
    --center-crop`` in one shell, started in the background."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(out_dir, "images")
    write_tool_images(root)
    lst, rec = (os.path.join(out_dir, f"tools.{e}") for e in ("lst", "rec"))
    tool = f"{sys.executable} -m mxnet_tpu_torch.tools.im2rec"
    script = (f"{tool} --make-list {root} {lst} && {tool} {lst} {root} "
              f"{rec} --resize {TOOLS_RESIZE} --center-crop")
    return start_logged(["bash", "-c", script], out_dir, "im2rec",
                        cwd=repo), rec


class CommCalls:
    """Keeps the first int8 call of each of the exchange's kernel entry
    points (``fused_quantize``, ``fused_dequant_sum``, ``fused_dequant``):
    the kernels' inputs at the example's bucket shapes."""

    NAMES = ("fused_quantize", "fused_dequant_sum", "fused_dequant")

    def __init__(self, ck):
        self.ck, self.first, self.saved = ck, {}, {}

    def __enter__(self):
        for name in self.NAMES:
            self.saved[name] = getattr(self.ck, name)
            setattr(self.ck, name, self._wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ck, name, fn)

    def _wrap(self, name, fn):
        def call(spec, value, **kw):
            if spec.mode == "int8" and name not in self.first:
                kept = ({k: v.detach().clone() for k, v in value.items()}
                        if isinstance(value, dict)
                        else value.detach().clone())
                self.first[name] = (spec, kept, dict(kw))
            return fn(spec, value, **kw)

        return call


def comm_example_holds(torch, ck, calls):
    """Rows 3, 5 and 7 at the example's bucket shapes: one call of each
    kernel on the inputs the exchange gave it, bitwise against its plain
    version on the card."""
    rows = {}
    spec, value, kw = calls.first["fused_quantize"]
    r = value.to(torch.float32).contiguous()
    r = r[None] if r.dim() == 1 else r
    err = kw.get("error_rounding") or ("sub" if kw.get("want_error")
                                       else None)
    got = ck.quant_int8(r, spec.chunk, True, err)
    want = ck.quant_int8_plain(r, spec.chunk, True, err)
    rows["quant_int8"] = {
        "shape": list(r.shape), "chunk": spec.chunk, "err": err,
        "bitwise": all(torch.equal(a, b) for a, b in zip(got, want)
                       if a is not None)}
    for name, kernel, plain in (
            ("fused_dequant_sum", ck.dequant_sum_int8,
             ck.dequant_sum_int8_plain),
            ("fused_dequant", ck.dequant_int8, ck.dequant_int8_plain)):
        spec, payload, _ = calls.first[name]
        q, scale = payload["q"].contiguous(), payload["scale"].contiguous()
        if q.dim() == 1:
            q, scale = q[None], scale[None]
        got = kernel(q, scale, spec.chunk)
        rows[kernel.__name__] = {
            "shape": list(q.shape), "chunk": spec.chunk,
            "bitwise": torch.equal(got, plain(q, scale, spec.chunk))}
    torch.cuda.synchronize()
    for name, row in rows.items():
        require(row["bitwise"], f"tools_examples: {name} at the example's "
                f"bucket shape {row['shape']} equals its plain version "
                "bitwise")
    return rows


def longlm_expected(coords):
    """The flash kernels' launches on one rank of train_long_lm's run, each
    of flash_fwd, flash_bwd_dq and flash_bwd_dkv alike: causal ring
    attention over sp = 2 runs, in each layer's forward, the diagonal
    block on every rank and the block of the earlier shard on the rank of
    sp index 1 (the later shard's block is masked out whole and skipped),
    and the backward's dq and dk/dv the same blocks: steps x layers x
    (sp index + 1)."""
    return LONGLM_STEPS * LONGLM_LAYERS * (coords["sp"] + 1)


def longlm_body(torch, rank, world):
    """One rank of train_long_lm ``--dp 2 --sp 2 --flash`` on the card:
    the launcher's variables, then the script's ``main(argv)``. Returns its
    losses, launches, coordinates and seconds."""
    import contextlib
    import io
    import os

    from mxnet_tpu_torch.examples.long_context import train_long_lm
    from mxnet_tpu_torch.parallel.mesh import AXES

    os.environ.update(MXTPU_NUM_WORKERS=str(world),
                      MXTPU_WORKER_RANK=str(rank))
    sizes = {a: 1 for a in AXES}
    sizes.update(dp=LONGLM_DP, sp=LONGLM_SP)
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
        rank, [sizes[a] for a in AXES]))))
    reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        first, last, losses = train_long_lm.main(
            ["--dp", str(LONGLM_DP), "--sp", str(LONGLM_SP), "--flash",
             "--steps", str(LONGLM_STEPS), "--layers", str(LONGLM_LAYERS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"coords": coords, "first": first, "last": last,
            "losses_every_100": losses[::100], "seconds": seconds,
            "launches": read_launches(), "printed": out.getvalue()}


def longlm_flash_holds(torch, tfa):
    """The three flash kernels at the example's rank-local shape, f32, row
    by row against their plain versions as phase flash holds them: the
    ring's diagonal block (causal, views of one packed qkv) and its
    off-diagonal block (k and v of their own)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    bound = flash_row_bound(torch, torch.float32)
    worst = {}
    for causal, seq_k in ((True, None), (False, LONGLM_FLASH_SHAPE[2])):
        q, k, v, do = flash_operands(torch, LONGLM_FLASH_SHAPE,
                                     torch.float32, gen, seq_k)
        o, lse = tfa.flash_fwd(q, k, v, causal)
        delta = tfa.attention_delta(o, do)
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        po, plse = tfa.flash_fwd_plain(q, k, v, causal)
        pdq, pdk, pdv = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        lse_err = float(((lse - plse).abs() / plse.abs().clamp_min(1)).max())
        require(lse_err <= LSE_BOUND, f"tools_examples: flash_fwd's lse at "
                f"{LONGLM_FLASH_SHAPE} causal={causal} reads {lse_err}")
        for kernel, name, got, want in (
                ("flash_fwd", "o", o, po), ("flash_bwd_dq", "dq", dq, pdq),
                ("flash_bwd_dkv", "dk", dk, pdk),
                ("flash_bwd_dkv", "dv", dv, pdv)):
            share = float(row_errors(torch, got, want, bound)[0].max())
            key = f"{name}_{'diagonal' if causal else 'off_diagonal'}"
            worst[key] = {"kernel": kernel, "share_of_bound_max": share,
                          "max_abs_err": float((got - want).abs().max())}
            require(share <= 1.0,
                    f"tools_examples: {kernel} at {LONGLM_FLASH_SHAPE} f32 "
                    f"causal={causal}: a row of {name} reads {share} of its "
                    "bound")
    return worst


def caffe_card_check(torch, mt, out_dir):
    """The LeNet prototxt and seeded blobs through the converter's CLIs
    (``convert_symbol``, ``convert_model`` from an ``.npz`` dump) into a
    checkpoint pair, loaded by ``FeedForward.load`` on gpu(0) and on the
    CPU; the two forwards (TF32 off) within CAFFE_BOUND."""
    import contextlib
    import io
    import os

    from mxnet_tpu_torch.tools.caffe_converter import (convert_model,
                                                       convert_symbol)

    proto = os.path.join(out_dir, "lenet.prototxt")
    with open(proto, "w") as f:
        f.write(CAFFE_LENET)
    npz = os.path.join(out_dir, "lenet_blobs.npz")
    np.savez(npz, **{f"{layer}/{i}": a
                     for layer, arrs in caffe_blobs().items()
                     for i, a in enumerate(arrs)})
    prefix = os.path.join(out_dir, "lenet")
    with contextlib.redirect_stdout(io.StringIO()):
        convert_symbol.main([proto, prefix + "-converted-symbol.json"])
        convert_model.main([proto, npz, prefix])
    x = np.random.RandomState(1).rand(2, 1, 28, 28).astype(np.float32)
    outs = {}
    for name, ctx in (("gpu", mt.gpu(0)), ("cpu", mt.cpu())):
        model = mt.FeedForward.load(prefix, 0, ctx=ctx)
        outs[name] = np.asarray(model.predict(x))
    err = float(np.abs(outs["gpu"] - outs["cpu"]).max())
    require(outs["gpu"].shape == (2, 10) and np.isfinite(outs["gpu"]).all()
            and err <= CAFFE_BOUND,
            f"tools_examples: the converted LeNet on the card against the "
            f"CPU reads {err:.3e} (bound {CAFFE_BOUND})")
    return {"max_abs_err": err, "bound": CAFFE_BOUND,
            "outputs": list(outs["gpu"].shape)}


def phase_tools_examples(torch, mt):
    """12c. The port's tools and launched examples on the card. (a) The
    repo's ``tools/launch.py -n 2`` runs ``mxnet_tpu_torch.examples.
    distributed.dist_sync_mlp`` (no ``--cpu``) in two workers that share the
    card: exit 0, both accuracy lines above the script's 0.95, each worker's
    peak card bytes above 0 (its model on the card), each joined with gloo
    (the kvstore's log line); started first, read last. (b)
    ``elastic_train.main`` in this process over ``[gpu(0)] * 8``, with the
    exchange's kernels armed through ``MXNET_TPU_COMM_KERNELS=1`` (the
    script, as the JAX one, passes no ``comm_kernels``): the JAX
    script's membership history (8 -> 6, then 6 -> 8, with its reasons),
    a final accuracy above ELASTIC_EXAMPLE_ACCURACY (this phase's gate; the
    script asserts none), rows 3, 5 and 7 launched around the fit and held
    bitwise against their plain versions at the example's bucket shapes.
    (c) ``train_long_lm.main`` with ``--dp 2 --sp 2 --flash`` on four ranks
    sharing the card over gloo: the script's own assertion (loss below
    1.5), each rank's flash launches the count :func:`longlm_expected`
    derives, and the three flash kernels held row by row at the example's
    shape. (d) 64 seeded PNG sources packed by ``python -m
    mxnet_tpu_torch.tools.im2rec --resize 40 --center-crop`` on the card's
    host: the ``.rec``'s sha256 the JAX script's (TOOLS_REC_SHA256), read
    back through ``ImageRecordIter``; the Caffe LeNet converted through the
    CLIs and forwarded on gpu(0) against the CPU within CAFFE_BOUND.
    Returns the kernels' launches across (a)-(d) (the launched workers'
    are their own processes' and read 0 here)."""
    import hashlib
    import os
    import re
    from pathlib import Path

    from mxnet_tpu_torch.examples.distributed import elastic_train
    from mxnet_tpu_torch.kernels import comm_kernels as ck
    from mxnet_tpu_torch.kernels import flash_attention as tfa

    t_start = time.perf_counter()
    out_dir = Path(TOOLS_DIR)
    if out_dir.exists():
        import shutil

        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    launch = start_tools_launch(str(out_dir))
    im2rec, rec_path = start_tools_im2rec(str(out_dir))
    reset_launches()
    total = {n: 0 for n in read_launches()}

    def add(got):
        for n, c in got.items():
            total[n] += c

    # (b) elastic_train over [gpu(0)] * 8
    import contextlib
    import io

    printed = io.StringIO()
    t0 = time.perf_counter()
    # the script passes no comm_kernels, as the JAX script does: its
    # exchange takes the kernels through the package's own gate
    prior = os.environ.get("MXNET_TPU_COMM_KERNELS")
    os.environ["MXNET_TPU_COMM_KERNELS"] = "1"
    try:
        with CommCalls(ck) as calls, contextlib.redirect_stdout(printed):
            co, acc = elastic_train.main([str(out_dir / "elastic")])
    finally:
        if prior is None:
            del os.environ["MXNET_TPU_COMM_KERNELS"]
        else:
            os.environ["MXNET_TPU_COMM_KERNELS"] = prior
    torch.cuda.synchronize()
    elastic_s = time.perf_counter() - t0
    elastic_launches = read_launches()
    add(elastic_launches)
    history = [(h["from"], h["to"], h["reason"]) for h in co.history]
    require(history == ELASTIC_EXAMPLE_HISTORY,
            f"tools_examples: elastic_train's history {history} is the JAX "
            f"script's {ELASTIC_EXAMPLE_HISTORY}")
    require(">>> losing ranks 7 and 6" in printed.getvalue()
            and ">>> capacity returned: [6, 7]" in printed.getvalue(),
            "tools_examples: elastic_train printed its churn")
    require(acc > ELASTIC_EXAMPLE_ACCURACY,
            f"tools_examples: elastic_train's final accuracy {acc} is above "
            f"{ELASTIC_EXAMPLE_ACCURACY} (this phase's gate)")
    for name in ("quant_int8", "dequant_sum_int8", "dequant_int8"):
        require(elastic_launches[name] > 0,
                f"tools_examples: elastic_train launched {name}")
    reset_launches()
    comm_rows = comm_example_holds(torch, ck, calls)
    reset_launches()
    gc.collect()
    torch.cuda.empty_cache()

    # (c) train_long_lm --dp 2 --sp 2 --flash on four ranks
    t0 = time.perf_counter()
    ranks = run_ranks(torch, longlm_body, LONGLM_DP * LONGLM_SP,
                      LONGLM_TIMEOUT_S, "tools_examples train_long_lm")
    longlm_s = time.perf_counter() - t0
    for rank, res in enumerate(ranks):
        add(res["launches"])
        want = longlm_expected(res["coords"])
        for name in FLASH_NAMES:
            require(res["launches"][name] == want,
                    f"tools_examples: train_long_lm rank {rank} "
                    f"({res['coords']}) launched {name} "
                    f"{res['launches'][name]} times, derived {want}")
        require(np.isfinite(res["last"]) and res["last"] < LONGLM_LOSS_BOUND,
                f"tools_examples: train_long_lm rank {rank}'s last loss "
                f"{res['last']} is below {LONGLM_LOSS_BOUND}")
    require(len({r["last"] for r in ranks}) == 1,
            "tools_examples: every rank of train_long_lm reads one loss")
    flash_rows = longlm_flash_holds(torch, tfa)
    reset_launches()

    # (d) the tools: im2rec's records, then the Caffe converter
    rc, out, err, im2rec_s = finish_logged(im2rec, TOOLS_IM2REC_TIMEOUT_S)
    require(rc == 0, f"tools_examples: im2rec exits 0 (exit {rc}: "
            f"{err[-1500:]})")
    sha = hashlib.sha256(Path(rec_path).read_bytes()).hexdigest()
    require(sha == TOOLS_REC_SHA256,
            f"tools_examples: im2rec's .rec sha256 {sha} is the JAX "
            f"script's {TOOLS_REC_SHA256}")
    it = mt.io.ImageRecordIter(
        path_imgrec=rec_path, data_shape=(3, TOOLS_RESIZE, TOOLS_RESIZE),
        batch_size=16)
    read = 0
    labels = []
    for batch in it:
        read += batch.data[0].shape[0] - getattr(batch, "pad", 0)
        labels.append(np.asarray(batch.label[0]).ravel())
    require(read == TOOLS_IMAGES
            and sorted(set(np.concatenate(labels).tolist())) ==
            [float(c) for c in range(TOOLS_CLASSES)],
            f"tools_examples: ImageRecordIter read {read} records of "
            f"{TOOLS_IMAGES} with every class")
    caffe = caffe_card_check(torch, mt, str(out_dir))
    add(read_launches())

    # (a) the launcher's run, read last
    rc, out, err, launch_s = finish_logged(launch, TOOLS_LAUNCH_TIMEOUT_S)
    require(rc == 0, f"tools_examples: tools/launch.py -n 2 dist_sync_mlp "
            f"exits 0 (exit {rc}: {err[-2000:]})")
    # the two workers print into one pipe: a line of one may split another
    accs = [float(a) for a in
            re.findall(r"dist_sync_mlp accuracy = (\d\.\d+)", out)]
    peaks = [int(p.read_text()) for p in
             sorted(out_dir.glob("card_peak_bytes.*"))]
    joined = re.findall(r"rank \d joined the 2-rank world with gloo", err)
    require(len(accs) == TOOLS_LAUNCH_WORKERS
            and min(accs) > TOOLS_MLP_ACCURACY,
            f"tools_examples: both workers' accuracy lines above "
            f"{TOOLS_MLP_ACCURACY}: {accs}")
    require(len(peaks) == TOOLS_LAUNCH_WORKERS and min(peaks) > 0,
            f"tools_examples: both workers held their models on the card "
            f"(peak bytes {peaks})")
    require(len(joined) == TOOLS_LAUNCH_WORKERS,
            f"tools_examples: both workers joined gloo: {joined}")

    phase_s = time.perf_counter() - t_start
    r0 = ranks[0]
    emit({"phase": "tools_examples",
          "launch": {"command": "tools/launch.py -n 2 python -m mxnet_tpu_"
                                "torch.examples.distributed.dist_sync_mlp",
                     "exit": rc, "seconds": launch_s, "accuracy": accs,
                     "card_peak_bytes": peaks, "joined": joined},
          "elastic": {"replicas": "[gpu(0)] * 8", "seconds": elastic_s,
                      "history": [{"from": h["from"], "to": h["to"],
                                   "reason": h["reason"],
                                   "downtime_s": h["downtime_s"]}
                                  for h in co.history],
                      "accuracy": acc, "accuracy_gate":
                      ELASTIC_EXAMPLE_ACCURACY,
                      "launches": elastic_launches,
                      "bucket_holds": comm_rows},
          "train_long_lm": {"dp": LONGLM_DP, "sp": LONGLM_SP,
                            "steps": LONGLM_STEPS, "seconds": longlm_s,
                            "step_ms": 1e3 * r0["seconds"] / LONGLM_STEPS,
                            "first_loss": r0["first"],
                            "final_loss": r0["last"],
                            "losses_every_100": r0["losses_every_100"],
                            "launches_by_rank": [
                                {"coords": r["coords"],
                                 "launches": {n: r["launches"][n]
                                              for n in FLASH_NAMES},
                                 "derived": longlm_expected(r["coords"])}
                                for r in ranks],
                            "flash_holds": flash_rows},
          "im2rec": {"images": TOOLS_IMAGES, "resize": TOOLS_RESIZE,
                     "sha256": sha, "seconds": im2rec_s, "read": read},
          "caffe": caffe,
          "phase_s": phase_s, "budget_s": TOOLS_BUDGET_S,
          "launches": total})
    gc.collect()
    torch.cuda.empty_cache()
    return total


# -- slice 25: the single-process examples ------------------------------------

EXAMPLES_DIR = "build/chip_smoke/examples"
EXAMPLES_BUDGET_S = 150
# each script at the JAX script's defaults, in examples/README.md's order;
# every run is one main(argv) in this process, on gpu(0)
EXAMPLE_RUNS = (
    ("mnist", "mnist.train_mnist", ()),
    ("cifar10", "cifar10.train_cifar10", ()),
    ("imagenet", "imagenet.train_imagenet", ()),
    ("lstm_ptb", "rnn.lstm_ptb", ()),
    ("lstm_scan", "rnn.lstm_scan", ()),
    ("lstm_bucketing", "rnn.lstm_bucketing", ()),
    ("composite_symbol", "notebooks.composite_symbol", ()),
    ("simple_bind", "notebooks.simple_bind", ()),
    ("module_api", "notebooks.module_api", ()),
    ("cifar_recipe", "notebooks.cifar_recipe", ()),
    ("cifar100_advanced", "notebooks.cifar100_advanced", ()),
    ("numpy_softmax", "numpy_ops.numpy_softmax", ()),
    ("basics", "python_howto.basics", ()),
    ("fgsm", "adversary.fgsm", ()),
    ("memcost", "memcost.memcost", ()),
)
# sha256 of what the JAX scripts' functions write, computed from them
# (tests/test_torch_examples_{vision,notebooks}.py hold the port's functions
# to them byte for byte): synthetic_mnist's X then y bytes, and the JPEG
# shards (PIL 12.1.0's encoder), by their paths under TMPDIR
EXAMPLES_SHA256 = {
    "mnist": "c3fb8b3d948895f90a0bada90108ae2eb0a3996ef93f5fe4f2bd29bcc9be2ec7",
    "cifar_synth.rec":
        "8c2da9aae720b3ae8f0004fa128cfe1a2464bc1be4c5f0ddeeaa405e4503f077",
    "imagenet_synth_512.rec":
        "4496b6607247a199ea164c9044240ab050b9c745b8d6e927c7de5c5b20f614c0",
    "cifar_recipe_*/train.rec":
        "c56835852abf65a9548618fc0ecbd549d8e24d9afbced974aa4ab9e5dc5a746f",
    "cifar_recipe_*/val.rec":
        "81dfc22526dca395e2341b4ebeecbfceea2b6a5ac40bb5259dcda652b598b05d",
    "cifar100_*/train.rec":
        "acd452fa10a1af10dff7374d5b60d247b74097b3314304dc980c025b01974aa1",
    "cifar100_*/val.rec":
        "8db47461c26a761384dcbb25854c7ef4d8fec0b4c1fa97e8afc4c5e699a782a7",
}
EXAMPLES_MNIST_ACCURACY = 0.95  # this phase's gate; the JAX script asserts none
# the launched tier, tests/test_multiprocess_dist.py:101-128's for the JAX
# script: AlexNet, dist_sync, two workers sharing the card, 64 synthetic
# images (2 batches of 16 a worker), started first and read last
EXAMPLES_LAUNCH_ARGV = ("--network", "alexnet", "--kv-store", "dist_sync",
                        "--batch-size", "16", "--num-epochs", "1")
EXAMPLES_LAUNCH_IMAGES = 64
EXAMPLES_LAUNCH_TIMEOUT_S = 300
# a launched worker: the script as `python -m` runs it, then its peak card
# bytes in a file of its own (two workers share one stdout)
EXAMPLES_WORKER = (
    "import os, runpy, sys\n"
    "sys.argv = ['{module}', *{argv!r}]\n"
    "runpy.run_module('{module}', run_name='__main__', alter_sys=True)\n"
    "import torch\n"
    "rank = os.environ['MXTPU_WORKER_RANK']\n"
    "with open(os.path.join({out_dir!r}, 'card_peak_bytes.' + rank), "
    "'w') as f:\n"
    "    f.write(str(torch.cuda.max_memory_allocated()))\n")
# the JAX script's no_optimization number (tests/test_torch_examples_misc.py)
MEMCOST_NO_OPT_BYTES = 438962344
FUSED_ADAM_KERNEL = "fused_adam_kernel"  # csrc/fused_adam.cu's __global__


def run_example(torch, module, argv):
    """``mxnet_tpu_torch.examples.<module>.main(argv)`` in this process: its
    result, what it printed and logged, its seconds, the card bytes it
    held at its peak above what the card held before it, and the kernels'
    launches, set to 0 just before it and read just after."""
    import importlib
    import io
    import logging

    mod = importlib.import_module(f"mxnet_tpu_torch.examples.{module}")
    printed, logged = io.StringIO(), io.StringIO()
    root = logging.getLogger()
    saved = root.level, root.handlers[:]
    # the scripts' basicConfig finds this handler and adds none
    root.handlers = [logging.StreamHandler(logged)]
    root.setLevel(logging.INFO)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            result = mod.main(list(argv))
        torch.cuda.synchronize()
    finally:
        root.handlers, root.level = saved[1], saved[0]
    return {"result": result, "printed": printed.getvalue(),
            "logged": logged.getvalue(),
            "seconds": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated() - base,
            "launches": read_launches()}


class FirstAdamStep:
    """Keeps the inputs of the first eager ``fused_adam_step`` the
    optimizer calls (``mxnet_tpu_torch.optimizer``'s name), to hold that
    launch against its plain version at the example's leaves."""

    def __init__(self, torch, topt):
        self.torch, self.topt, self.kept = torch, topt, None

    def __enter__(self):
        self.orig = self.topt.fused_adam_step

        def keep(params, grads, ms, vs, scal, **kw):
            if self.kept is None and \
                    not self.torch.cuda.is_current_stream_capturing():
                self.kept = ([[t.detach().clone() for t in group]
                              for group in (params, grads, ms, vs)],
                             scal.detach().clone(),
                             {k: v for k, v in kw.items() if k != "table"})
            return self.orig(params, grads, ms, vs, scal, **kw)

        self.topt.fused_adam_step = keep
        return self

    def __exit__(self, *exc):
        self.topt.fused_adam_step = self.orig

    def hold(self, kfa):
        """The kept step through the kernel and through
        ``fused_adam_step_plain`` on copies: bitwise, as phase fused_adam
        holds it."""
        torch = self.torch
        groups, scal, hyper = self.kept
        a = [[t.clone() for t in g] for g in groups]
        b = [[t.clone() for t in g] for g in groups]
        kfa.fused_adam_step(*a, scal.clone(), table=kfa.LeafTable(), **hyper)
        kfa.fused_adam_step_plain(*b, scal.clone(), **hyper)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for ga, gb in zip(a, b)
                  for x, y in zip(ga, gb) if x.numel())
        bitwise = all(torch.equal(x, y) for ga, gb in zip(a, b)
                      for x, y in zip(ga, gb))
        return {"leaves": len(groups[0]),
                "elements": sum(t.numel() for t in groups[0]),
                "bitwise": bitwise, "max_abs_err": err}


def start_examples_launch(out_dir):
    """``tools/launch.py -n 2`` running ``mxnet_tpu_torch.examples.imagenet.
    train_imagenet`` with EXAMPLES_LAUNCH_ARGV on the card (no ``--cpu``),
    TMPDIR ``out_dir`` (rank 0 writes the shard and the checkpoint there)."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    module = "mxnet_tpu_torch.examples.imagenet.train_imagenet"
    out_dir = os.path.abspath(out_dir)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env.update(TMPDIR=out_dir,
               MXTPU_SYNTH_IMAGES=str(EXAMPLES_LAUNCH_IMAGES))
    return start_logged(
        [sys.executable, os.path.join(repo, "tools", "launch.py"), "-n", "2",
         sys.executable, "-c",
         EXAMPLES_WORKER.format(module=module, argv=list(EXAMPLES_LAUNCH_ARGV),
                                out_dir=out_dir)],
        out_dir, "launch", cwd=repo, env=env)


def finish_examples_launch(started, out_dir):
    """The launched tier's checks: exit 0, both ranks logged their epoch
    (four or more ``Epoch[0]`` lines) in a real two-rank world over gloo,
    no fallback to one process, each worker's model on the card, rank 0's
    shard and its checkpoint alone."""
    import glob
    import os
    import re

    rc, out, err, seconds = finish_logged(started, EXAMPLES_LAUNCH_TIMEOUT_S)
    text = out + err
    require(rc == 0, f"examples: the launched imagenet tier exits 0 (exit "
            f"{rc}: {text[-2000:]})")
    peaks = [int(open(p).read()) for p in
             sorted(glob.glob(os.path.join(out_dir, "card_peak_bytes.*")))]
    joined = re.findall(r"rank \d joined the 2-rank world with gloo", text)
    ckpts = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(out_dir, "alexnet-*.params")))
    require(text.count("Epoch[0]") >= 4
            and "continuing single-process" not in text
            and len(joined) == 2 and len(peaks) == 2 and min(peaks) > 0
            and ckpts == ["alexnet-0001.params"] and os.path.exists(
                os.path.join(out_dir,
                             f"imagenet_synth_{EXAMPLES_LAUNCH_IMAGES}.rec")),
            f"examples: the launched tier's two ranks trained on the card "
            f"(Epoch[0] lines {text.count('Epoch[0]')}, joined {joined}, "
            f"peaks {peaks}, checkpoints {ckpts})")
    return {"command": "tools/launch.py -n 2 python -m mxnet_tpu_torch."
                       "examples.imagenet.train_imagenet "
                       + " ".join(EXAMPLES_LAUNCH_ARGV),
            "exit": rc, "seconds": seconds, "card_peak_bytes": peaks,
            "joined": joined, "checkpoints": ckpts}


def example_summary(name, run):
    """The numbers a script's run ends with, for its row."""
    import re

    res = run["result"]
    trained = re.findall(r"Train-accuracy=([\d.]+)", run["logged"])
    if name == "mnist":
        return {"val_accuracy": float(res)}
    if name in ("cifar10", "imagenet", "lstm_bucketing"):
        return {"train_accuracy_by_epoch": [float(a) for a in trained]}
    if name == "lstm_ptb":
        return {"perplexity_by_epoch": res["perplexity"]}
    if name == "lstm_scan":
        return {"steps": len(res["losses"]), "first_loss": res["losses"][0],
                "last_loss": res["losses"][-1],
                "final_perplexity": res["final_perplexity"],
                "tokens_per_s": res["tokens_per_s"]}
    if name == "composite_symbol":
        return {"out_shape": list(res["out_shape"]),
                "json_bytes": len(res["json"])}
    if name == "simple_bind":
        return {"val_acc_by_epoch": res["val_acc"]}
    if name == "module_api":
        return dict(res)
    if name == "cifar_recipe":
        return {"restored_val_accuracy": res["accuracy"],
                "features": list(res["features"])}
    if name == "cifar100_advanced":
        return {"predicted": list(res.shape)}
    if name == "numpy_softmax":
        return {"train_accuracy": float(res)}
    if name == "basics":
        return {"device": res["card"]}
    if name == "fgsm":
        return {"clean_acc": res["clean_acc"], "adv_acc": res["adv_acc"]}
    if name == "memcost":
        return {"bytes": res[0], "card_peak_bytes": res[1]}
    return {}


def example_gates(torch, name, run, tmp):
    """Each script's result beyond its own assertions (which raised if they
    failed): the printed lines the JAX script prints, finite values that
    moved, and what the script wrote."""
    import os

    res, printed, logged = run["result"], run["printed"], run["logged"]

    def finite(params):
        return all(bool(torch.isfinite(v).all()) for v in params.values())

    if name == "mnist":
        require(res >= EXAMPLES_MNIST_ACCURACY
                and "final val accuracy:" in printed,
                f"examples: mnist's final val accuracy {res} is at least "
                f"{EXAMPLES_MNIST_ACCURACY} (this phase's gate)")
    elif name in ("cifar10", "imagenet"):
        epochs = 2 if name == "cifar10" else 1
        require(finite(res.arg_params) and finite(res.aux_params)
                and f"Epoch[{epochs - 1}] Train-accuracy" in logged,
                f"examples: {name} trained {epochs} epoch(s) to finite "
                "parameters")
        if name == "imagenet":
            require(os.path.exists(os.path.join(tmp, "resnet-50-0001.params")),
                    "examples: imagenet's rank 0 wrote its checkpoint")
    elif name == "lstm_ptb":
        ppl = res["perplexity"]
        require(len(ppl) == 2 and np.isfinite(ppl).all() and ppl[1] < ppl[0]
                and logged.count("perplexity=") == 2,
                f"examples: lstm_ptb's perplexity falls over its 2 epochs: "
                f"{ppl}")
    elif name == "lstm_scan":
        # --steps 200, cut to the batches of its 100,000-character stream
        steps = min(200, (100000 - 1) // (64 * 32))
        losses = res["losses"]
        require(len(losses) == steps and np.isfinite(losses).all()
                and losses[-1] < losses[0] and "final perplexity=" in logged,
                f"examples: lstm_scan's {steps} losses fall: {losses[0]} -> "
                f"{losses[-1]}")
    elif name == "lstm_bucketing":
        require(finite(res.arg_params) and "Epoch[4] Train-accuracy" in logged,
                "examples: lstm_bucketing trained 5 epochs to finite "
                "parameters")
    elif name == "composite_symbol":
        path = os.path.join(tmp, "composite_symbol.dot")
        with open(path) as f:
            dot = f.read()
        require(res["out_shape"] == (2, 1000) and dot == res["dot"]
                and "JSON round-trip OK" in printed,
                "examples: composite_symbol's shapes, .dot and JSON")
    elif name == "simple_bind":
        require("simple_bind training converged." in printed,
                "examples: simple_bind converged")
    elif name == "cifar_recipe":
        require(res["features"][1:] == (64, 1, 1)
                and "cifar recipe complete." in printed,
                "examples: cifar_recipe's restore and features")
    elif name == "cifar100_advanced":
        require(res.shape == (500, 100)
                and "walkthrough complete; predicted (500, 100)" in printed,
                "examples: cifar100_advanced predicted")
    elif name == "basics":
        require(res["card"].startswith("cuda")
                and "symbol JSON roundtrip ok" in printed,
                f"examples: basics' NDArrays on the card ({res['card']})")
    elif name == "memcost":
        got, card = res
        require(got["no_optimization"] == MEMCOST_NO_OPT_BYTES,
                f"examples: memcost's no_optimization {got['no_optimization']}"
                f" is the JAX script's {MEMCOST_NO_OPT_BYTES}")
        require(got["train"] > got["remat"] > got["forward_only"] > 0
                and all(v and v > 0 for v in card.values())
                and "unavailable" not in printed,
                f"examples: memcost's counts ordered and the card's peaks "
                f"read: {got} {card}")
    if name != "composite_symbol":  # it builds symbols only
        require(run["peak_bytes"] > 0,
                f"examples: {name} held its tensors on the card (peak "
                f"{run['peak_bytes']} bytes above the card's before)")


def examples_shards(tmp):
    """The sha256 of the data the scripts made, against the JAX functions'."""
    import glob
    import hashlib
    import os

    from mxnet_tpu_torch.examples.mnist import train_mnist

    h = hashlib.sha256()
    for a in train_mnist.synthetic_mnist():
        h.update(a.tobytes())
    got = {"mnist": h.hexdigest()}
    for key in EXAMPLES_SHA256:
        if key == "mnist":
            continue
        paths = glob.glob(os.path.join(tmp, key))
        require(len(paths) == 1, f"examples: one {key} under {tmp}: {paths}")
        with open(paths[0], "rb") as f:
            got[key] = hashlib.sha256(f.read()).hexdigest()
    for key, want in EXAMPLES_SHA256.items():
        require(got[key] == want, f"examples: {key}'s sha256 {got[key]} is "
                f"the JAX function's {want}")
    return got


def phase_examples(torch, mt):
    """12d. The fifteen single-process examples on the card, each through
    its ``main(argv)`` at the JAX script's defaults (no ``--cpu``), in this
    process, with TMPDIR a directory of the phase's own (their shards,
    checkpoints and ``.dot`` land there). ``lstm_bucketing`` runs under the
    package's gate ``MXNET_TPU_FUSED_ADAM=1`` (the script passes no
    ``fused``, as the JAX one) and under ``torch.profiler``: fused_adam
    launched once a batch, ``batches_per_epoch() * EPOCHS`` as derived
    from the script's corpus, by the wrapper's count and by the trace's
    kernels; its first launch held bitwise against its plain version.
    Beside them, in the background from the phase's start, the repo's
    ``tools/launch.py -n 2`` runs ``imagenet``'s ``dist_sync`` tier on the
    card (AlexNet, two workers sharing it over gloo), read last. Returns the
    kernels' launches over the fifteen runs, each read around its own run
    (the launched workers count in their own processes)."""
    import os
    import shutil
    import tempfile

    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing
    from mxnet_tpu_torch.kernels import fused_adam as kfa

    t_start = time.perf_counter()
    mt.set_matmul_precision("highest")
    tmp = os.path.abspath(os.path.join(EXAMPLES_DIR, "tmp"))
    if os.path.exists(EXAMPLES_DIR):
        shutil.rmtree(EXAMPLES_DIR)
    os.makedirs(tmp)
    launch_dir = os.path.join(EXAMPLES_DIR, "launch")
    os.makedirs(launch_dir)
    launch = start_examples_launch(launch_dir)
    prior = {k: os.environ.get(k) for k in ("TMPDIR", "MXNET_TPU_FUSED_ADAM")}
    prior_tempdir = tempfile.tempdir
    os.environ["TMPDIR"], tempfile.tempdir = tmp, tmp
    total = {n: 0 for n in read_launches()}
    rows, adam = {}, {}
    cuda = torch.autograd.DeviceType.CUDA
    try:
        for name, module, argv in EXAMPLE_RUNS:
            if name != "lstm_bucketing":
                run = run_example(torch, module, argv)
            else:
                os.environ["MXNET_TPU_FUSED_ADAM"] = "1"
                with FirstAdamStep(torch, topt) as first, \
                        torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                    run = run_example(torch, module, argv)
                del os.environ["MXNET_TPU_FUSED_ADAM"]
                traced = sum(
                    1 for e in prof.profiler.kineto_results.events()
                    if e.device_type() == cuda
                    and FUSED_ADAM_KERNEL in e.name())
                derived = lstm_bucketing.batches_per_epoch() * \
                    lstm_bucketing.EPOCHS
                counted = run["launches"]["fused_adam"]
                require(counted == traced == derived,
                        f"examples: lstm_bucketing launched fused_adam "
                        f"{counted} times (the trace: {traced}), derived "
                        f"{derived}")
                reset_launches()
                adam = {"derived": derived, "counted": counted,
                        "traced": traced, **first.hold(kfa)}
                reset_launches()
                require(adam["bitwise"],
                        "examples: lstm_bucketing's first fused_adam launch "
                        "equals fused_adam_step_plain bitwise "
                        f"(max abs {adam['max_abs_err']})")
            for k, v in run["launches"].items():
                total[k] += v
            rows[name] = {"seconds": run["seconds"],
                          "result": example_summary(name, run),
                          "peak_card_bytes": run["peak_bytes"],
                          "launches": {k: v for k, v in run["launches"]
                                       .items() if v}}
            emit({"phase": "examples_script", "name": name, **rows[name]})
            example_gates(torch, name, run, tmp)
            del run
            gc.collect()
            torch.cuda.empty_cache()
        shards = examples_shards(tmp)
        launched = finish_examples_launch(launch, launch_dir)
    finally:
        # a failed check leaves the launcher running: it passes SIGTERM on
        # to its workers
        if launch[0].poll() is None:
            launch[0].terminate()
            try:
                launch[0].wait(timeout=30)
            except subprocess.TimeoutExpired:
                launch[0].kill()
                launch[0].wait()
        tempfile.tempdir = prior_tempdir
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    phase_s = time.perf_counter() - t_start
    emit({"phase": "examples", "scripts": rows, "fused_adam": adam,
          "sha256": shards, "launched": launched, "phase_s": phase_s,
          "budget_s": EXAMPLES_BUDGET_S, "launches": total})
    return total



# -- slice 26: the measurement tools -------------------------------------------

BENCH_TOOLS_DIR = "build/chip_smoke/bench_tools"
BENCH_TOOLS_BUDGET_S = 150
# each tool's main(argv) in this process, on gpu(0), at full width, in this
# order (scaling_projection reads bench_roofline's step); only repeat counts
# and bench_io_scaling's thread list may be cut, and every cut is listed
BENCH_TOOL_RUNS = (
    ("bench_flash", ("--iters", "5")),
    ("bench_longctx", ("--iters", "2")),
    ("bench_mnist", ("--iters", "20")),
    ("bench_roofline", ("--iters", "3")),
    ("scaling_projection", ("--roofline", "{dir}/bench_roofline.json")),
    ("bench_io_scaling", ("--threads", "1,4,8")),
)
BENCH_TOOLS_CUTS = {
    "bench_flash": "--iters 5 (default 10)",
    "bench_longctx": "--iters 2 (default 4)",
    "bench_mnist": "--iters 20 (default 50)",
    "bench_roofline": "--iters 3 (default 16)",
    "scaling_projection": "the step read from bench_roofline's JSON "
                          "(--roofline) instead of measured again",
    "bench_io_scaling": "--threads 1,4,8 (default 1,2,4,8 and the host's "
                        "cores where more)",
}
# bench_flash's flash_fwd at the LM's shape against phase flash's row 9 in
# the same run: both time single launches with L2 flushed (medians of 5 and
# 25), so they differ by the spread of the medians alone
BENCH_FLASH_ROW_BOUND = 0.15
# what the card may hold allocated when the phase starts, after every earlier
# phase, a collection and an empty cache: the cuBLAS workspaces PyTorch keeps
# for each handle and stream (32 MiB each; 4 of them, 135 MB in all, with one
# side stream a thread for the captured programs), against some 50 when each
# program took a stream of its own (2.27 GB by phase dp_train)
BENCH_TOOLS_START_BYTES = 1 << 30
# over the f32 rate outside the tensor cores (kernels/registry.py's
# H100_PEAK_OPS, the data sheet's) for a boost clock above the sheet's
F32_PEAK_MARGIN = 1.05
BENCH_LONGCTX_SEQS = (2048, 8192, 16384, 32768)


def bench_flash_library_rows(torch, records):
    """The yardstick of ROADMAP B's return rule at bench_flash's new shapes
    (every configuration but the LM's, which phase flash times): one
    ``F.scaled_dot_product_attention`` call and its backward (dq, dk and
    dv together) on contiguous copies of the same operands, timed as phase
    flash times them (median of 5). Beside them, the kernels' forward and
    their two backward kernels summed, from bench_flash's records."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for r in records:
        if (r["batch"], r["heads"], r["seq"]) == (LM_BATCH, 8, LM_SEQ):
            continue
        dtype = getattr(torch, r["dtype"])
        shape = (r["batch"], r["heads"], r["seq"], r["d"])
        q, k, v, do = flash_operands(torch, shape, dtype, gen)
        qc, kc, vc = (t.detach().contiguous().requires_grad_(True)
                      for t in (q, k, v))
        o = F.scaled_dot_product_attention(qc, kc, vc, is_causal=r["causal"])
        fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=r["causal"]), reps=5)
        bwd = time_ms(torch, lambda: torch.autograd.grad(
            o, (qc, kc, vc), do, retain_graph=True), reps=5)
        kern = r["kernels"]
        rows.append({"shape": list(shape), "dtype": r["dtype"],
                     "causal": r["causal"], "library_fwd_ms": fwd,
                     "library_bwd_ms": bwd,
                     "flash_fwd_ms": kern["flash_fwd"]["ms"],
                     "flash_bwd_ms": kern["flash_bwd_dq"]["ms"]
                     + kern["flash_bwd_dkv"]["ms"]})
        del q, k, v, do, qc, kc, vc, o
    torch.cuda.empty_cache()
    return rows


def bench_tool_summary(name, got):
    """What the phase's line keeps of a tool's JSON: all of it but the
    roofline's per-op table past its first 10 rows."""
    if name == "bench_roofline":
        return {**got, "per_op_top": got["per_op_top"][:10]}
    return got


def bench_tool_gates(name, got, launches, flash_rows):
    """The phase's gates on one tool's JSON and its launches."""
    from mxnet_tpu_torch.kernels.registry import H100_PEAK_OPS

    f32_peak = H100_PEAK_OPS["f32"] / 1e12 * F32_PEAK_MARGIN
    if name == "bench_flash":
        recs = got["records"]
        require(not [r for r in recs if "error" in r],
                f"bench_tools: bench_flash ran every configuration: "
                f"{[r for r in recs if 'error' in r]}")
        # bf16 under the measured bf16 GEMM rate, the f32 SIMT forms under
        # the card's f32 rate outside the tensor cores
        peaks = {"bfloat16": got["measured_bf16_matmul_peak_tflops"],
                 "float32": f32_peak}
        for dtype, peak in peaks.items():
            rates = [r[k] for r in recs if r["dtype"] == dtype
                     for k in ("fwd_tflops", "fwdbwd_tflops")]
            rates += [k["tflops"] for r in recs if r["dtype"] == dtype
                      for k in r["kernels"].values()]
            require(rates and 0 < min(rates) and max(rates) <= peak,
                    f"bench_tools: bench_flash's {dtype} rates ({max(rates)} "
                    f"TF/s at most) under {peak} TF/s")
        lm = next(r for r in recs if (r["batch"], r["heads"], r["seq"],
                                      r["d"], r["causal"]) ==
                  (LM_BATCH, 8, LM_SEQ, 64, True))
        ratio = lm["kernels"]["flash_fwd"]["ms"] / flash_rows["flash_fwd"]["ms"]
        require(abs(ratio - 1) <= BENCH_FLASH_ROW_BOUND,
                f"bench_tools: bench_flash's flash_fwd at the LM's shape "
                f"({lm['kernels']['flash_fwd']['ms']} ms) within "
                f"{BENCH_FLASH_ROW_BOUND:.0%} of phase flash's "
                f"({flash_rows['flash_fwd']['ms']} ms)")
        for n in FLASH_NAMES:
            derived = sum(r["launches"][n] for r in recs)
            require(launches[n] == derived,
                    f"bench_tools: bench_flash launched {n} {launches[n]} "
                    f"times, its sweep derives {derived}")
    elif name == "bench_longctx":
        got_cells = {(r["seq"], r["remat"]) for r in got["records"]
                     if r.get("oom") or r.get("step_ms", 0) > 0}
        want = {(s, m) for s in BENCH_LONGCTX_SEQS for m in (False, True)}
        require(got_cells == want and launches["flash_fwd"] > 0,
                f"bench_tools: bench_longctx has a row a seq and remat, "
                f"timed or oom: {sorted(got_cells)}")
    elif name == "bench_mnist":
        require(all(r["images_per_sec"] > 0 for r in got["records"])
                and len(got["records"]) == 2,
                "bench_tools: bench_mnist timed the MLP and LeNet")
    elif name == "bench_roofline":
        # the port's own traffic (what the tool publishes), not the
        # ideal-fusion floors, which sit ten times under the step
        floor = got["memory_floor_port_traffic_ms"]
        require(got["measured_step_ms"] >= floor,
                f"bench_tools: the roofline's step {got['measured_step_ms']} "
                f"ms is no faster than its traffic's floor {floor} ms")
        # the f32 step (TF32 off) under the card's f32 rate
        require(0 < got["step_tflops"] <= f32_peak,
                f"bench_tools: the f32 step's {got['step_tflops']} TF/s under "
                f"{f32_peak} TF/s")
    elif name == "scaling_projection":
        require(got["allreduce_payload_bytes_per_step"]
                == got["param_bytes_f32"]
                == got["profiled_allreduce"]["payload_bytes"],
                "bench_tools: the projection's payload is the gradient's "
                "bytes, as profiled")
    elif name == "bench_io_scaling":
        require(all(r["img_per_sec"] > 0 for r in got["records"]),
                "bench_tools: bench_io_scaling measured every thread count")


def phase_bench_tools(torch, smi, flash_rows):
    """12e. The six measurement tools on the card, each through its
    ``main(argv)`` in this process with ``--out`` in the phase's directory
    (never the JAX tools' files): bench_flash, bench_longctx, bench_mnist,
    bench_roofline, scaling_projection (from the roofline's JSON) and
    bench_io_scaling. Each tool's launches are set to 0 just before it and
    read just after. Gates: each exits and writes its JSON with this card's
    ``nvidia-smi`` line; bench_flash ran every configuration, its LM-shape
    flash_fwd within ``BENCH_FLASH_ROW_BOUND`` of phase flash's time and
    its launches what its sweep derives; no bf16 rate above the measured
    bf16 GEMM rate, no f32 rate above the card's f32 rate (the f32 SIMT
    flash forms, the roofline's f32 step); the roofline's step no faster
    than its traffic's floor (``memory_floor_port_traffic_ms``);
    bench_longctx a row for every seq and remat; the phase within its
    budget; and, as it starts, at most ``BENCH_TOOLS_START_BYTES`` left
    allocated by the earlier phases. Beside bench_flash, the library's
    attention at its shapes
    (:func:`bench_flash_library_rows`, outside the tools' launch counts).
    Returns the kernels' launches over the six tools."""
    import importlib
    import io
    import json
    import os
    import shutil

    t_start = time.perf_counter()
    if os.path.exists(BENCH_TOOLS_DIR):
        shutil.rmtree(BENCH_TOOLS_DIR)
    os.makedirs(BENCH_TOOLS_DIR)
    gc.collect()
    torch.cuda.empty_cache()
    card_bytes = {"allocated": torch.cuda.memory_allocated(),
                  "reserved": torch.cuda.memory_reserved()}
    require(card_bytes["allocated"] <= BENCH_TOOLS_START_BYTES,
            f"bench_tools: the earlier phases left {card_bytes['allocated']} "
            f"bytes allocated on the card (at most {BENCH_TOOLS_START_BYTES})")
    total = {n: 0 for n in read_launches()}
    rows, library = {}, []
    for name, argv in BENCH_TOOL_RUNS:
        mod = importlib.import_module(f"mxnet_tpu_torch.tools.{name}")
        out_path = os.path.join(BENCH_TOOLS_DIR, f"{name}.json")
        argv = [a.format(dir=BENCH_TOOLS_DIR) for a in argv] + [
            "--out", out_path]
        gc.collect()
        torch.cuda.empty_cache()
        printed = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        with open(out_path) as f:
            got = json.load(f)
        for k, v in launches.items():
            total[k] += v
        rows[name] = {"seconds": seconds, "argv": argv,
                      "launches": {k: v for k, v in launches.items() if v}}
        emit({"phase": "bench_tool", "name": name, **rows[name],
              "result": bench_tool_summary(name, got)})
        require(got["card"] == smi,
                f"bench_tools: {name}'s JSON names the card {got['card']!r}"
                f" ({smi!r})")
        bench_tool_gates(name, got, launches, flash_rows)
        if name == "bench_flash":
            library = bench_flash_library_rows(torch, got["records"])
            emit({"phase": "bench_flash_library", "rows": library})
    reset_launches()
    phase_s = time.perf_counter() - t_start
    require(phase_s <= BENCH_TOOLS_BUDGET_S,
            f"bench_tools: the phase took {phase_s:.1f} s of its "
            f"{BENCH_TOOLS_BUDGET_S} s budget")
    emit({"phase": "bench_tools", "tools": rows, "cuts": BENCH_TOOLS_CUTS,
          "library_beside_bench_flash": library,
          "phase_s": phase_s, "budget_s": BENCH_TOOLS_BUDGET_S,
          "card": smi, "card_bytes_at_start": card_bytes,
          "launches": total})
    return total


BENCH_SUBSYSTEMS_DIR = "build/chip_smoke/bench_subsystems"
BENCH_SUBSYSTEMS_BUDGET_S = 300
# each bench's main(argv) in this process (bench_compile's four children in
# processes of their own), on gpu(0), at full size, in bench.py's order of
# the issues that set their bounds; no count is cut
BENCH_SUBSYSTEMS = ("telemetry", "trace", "mem", "health", "profile", "comm",
                    "overlap", "kernels", "elastic", "ckpt", "lockwatch",
                    "controller", "compile")
BENCH_SUBSYSTEMS_CUTS = {}


def bench_subsystem_headline(got, path):
    """What the phase prints of a bench's JSON: its metric, value and unit,
    the JAX bounds it flags beside them (a miss on the card is a finding,
    ROADMAP C.1, not a failed run), and the path of the whole JSON."""
    return {**{k: got.get(k) for k in ("metric", "value", "unit",
                                       "bounds")}, "json": path}


def phase_bench_subsystems(torch, smi):
    """12f. bench.py's thirteen subsystem benches through the port's
    ``mxnet_tpu_torch.tools.bench_<name>``, each ``main(["--out", ...])``
    in this process at full size (bench_compile's children in their own),
    on eight replicas that time-share the card where the JAX bench runs a
    dp-8 mesh. Each bench's launches are set to 0 just before it and read
    just after. Gates: each JSON names this card as ``nvidia-smi`` does;
    each bench's correctness gates, its ``check(result)`` (lock-order
    cycles 0, the detection latencies, the evicted straggler and the
    backfilled flaky rank, worlds [6, 8] and [3, 4], recovery tiers t1/t2,
    wire bytes equal to the plan, bucket plans summing to the fused plan,
    the kernel path's zero quantize passes, fused_adam bitwise, coverage
    of at least 80%, a memory plan recorded by bench_mem's capture, the
    cold child's kernel build); bench_kernels launching every kernel; the
    phase within its budget. The JAX package's overhead bounds are printed
    with each bench's figures, met or missed. Returns the kernels'
    launches by bench."""
    import importlib
    import io
    import json
    import os
    import shutil

    t_start = time.perf_counter()
    if os.path.exists(BENCH_SUBSYSTEMS_DIR):
        shutil.rmtree(BENCH_SUBSYSTEMS_DIR)
    os.makedirs(BENCH_SUBSYSTEMS_DIR)
    by_bench, rows = {}, {}
    for name in BENCH_SUBSYSTEMS:
        mod = importlib.import_module(f"mxnet_tpu_torch.tools.bench_{name}")
        out_path = os.path.join(BENCH_SUBSYSTEMS_DIR,
                                f"BENCH_{name.upper()}_torch.json")
        gc.collect()
        torch.cuda.empty_cache()
        printed = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            mod.main(["--out", out_path])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        with open(out_path) as f:
            got = json.load(f)
        by_bench[name] = launches
        rows[name] = {"seconds": seconds,
                      "launches": {k: v for k, v in launches.items() if v}}
        emit({"phase": "bench_subsystem", "name": name, **rows[name],
              "headline": bench_subsystem_headline(got, out_path)})
        require(got["device"] == smi,
                f"bench_subsystems: {name}'s JSON names the card "
                f"{got['device']!r} ({smi!r})")
        try:
            mod.check(got)
        except AssertionError as e:
            require(False, f"bench_subsystems: {e}")
        if name == "kernels":
            for n in port_kernels():
                require(launches[n] > 0,
                        f"bench_subsystems: bench_kernels launched {n}")
    reset_launches()
    phase_s = time.perf_counter() - t_start
    require(phase_s <= BENCH_SUBSYSTEMS_BUDGET_S,
            f"bench_subsystems: the phase took {phase_s:.1f} s of its "
            f"{BENCH_SUBSYSTEMS_BUDGET_S} s budget")
    emit({"phase": "bench_subsystems", "benches": rows,
          "cuts": BENCH_SUBSYSTEMS_CUTS, "phase_s": phase_s,
          "budget_s": BENCH_SUBSYSTEMS_BUDGET_S, "card": smi})
    return by_bench


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mt
    # every phase that holds the card to a reference runs with f32
    # contractions; the slice 9 phases time "default" (TF32) beside it
    mt.set_matmul_precision("highest")
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch import comm
    from mxnet_tpu_torch.kernels import _common as common
    from mxnet_tpu_torch.kernels import comm_kernels as ck
    from mxnet_tpu_torch.kernels import flash_attention as tfa
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.kernels import int8_matmul as k8
    from mxnet_tpu_torch.kernels import registry

    smi, mxlint_cli, bindings_built = phase_card(torch, common)
    rows, max_err = phase_kernels(torch, k8, registry)
    launches = phase_slice(torch, mt, k8)
    adam_row, adam_err = phase_fused_adam(torch, topt, kfa, registry)
    train_launches, f32_row = phase_train(torch, mt)
    launches.update(train_launches)
    bf16_launches = phase_train_bf16(torch, mt, f32_row)
    phase_serve_bf16(torch, mt, k8)
    zoo_launches = phase_zoo(torch, mt)
    phase_ndarray(torch, mt)
    phase_monitor(torch, mt)
    torch.cuda.empty_cache()
    io_path, io_feed_launches = phase_io_feed(torch, mt)
    io_fit_launches, io_fit_rows = phase_io_fit(torch, mt, io_path)
    slice10 = {"io_feed": io_feed_launches,
               "io_fit": io_fit_launches,
               "lstm_bucketing": phase_lstm_bucketing(torch, mt),
               "lstm_scan": phase_lstm_scan(torch, mt)}
    torch.cuda.empty_cache()
    slice12 = {"train_bf16_remat": bf16_launches["bf16_remat"],
               "zoo_alexnet_remat": zoo_launches["alexnet_remat"],
               "io_native": phase_io_native(torch, mt, io_path,
                                            io_fit_rows)}
    slice13 = {"native_progressive": phase_native_progressive(torch, mt,
                                                              io_path)}
    slice14 = {"native_arith": phase_native_arith(torch, mt, io_path)}
    torch.cuda.empty_cache()
    graphs_launches = phase_graphs(torch, mt, kfa, k8, io_path)
    torch.cuda.empty_cache()
    ckpt_launches = phase_ckpt(torch, mt, kfa, io_path)
    torch.cuda.empty_cache()
    slice17 = {"telemetry": phase_telemetry(torch, mt)}
    torch.cuda.empty_cache()
    slice19 = {"guards": phase_guards(torch, mt)}
    torch.cuda.empty_cache()
    slice20 = {"elastic": phase_elastic(torch, mt)}
    torch.cuda.empty_cache()
    slice20["controller"] = phase_controller(torch, mt)
    torch.cuda.empty_cache()
    for name in ("fused_adam", "quant_int8", "dequant_sum_int8",
                 "dequant_int8"):
        require(sum(got[name] for got in slice20.values()) > 0,
                f"slice 20's paths launched {name}")
    flash_rows, flash_errs = phase_flash(torch, tfa, registry)
    serve_launches, lm_params, lm_grad_errs = phase_lm_serve(torch, mt, tfa)
    train_launches = phase_lm_train(torch, mt, topt, tfa, kfa, lm_params,
                                    lm_grad_errs)
    slice16 = {"lm_graphs": phase_lm_graphs(torch, mt, topt, lm_params)}
    require(serve_launches["flash_fwd"] > 0, "the LM forward ran flash_fwd")
    phase_lm_head(torch)
    launches.update({n: train_launches[n] for n in flash_rows})
    comm_rows_, comm_phase_launches = phase_comm_kernels(torch, ck, comm,
                                                         registry)
    bucket_rows = comm_bucket_rows(torch, ck, comm, registry)
    dp_launches, dp_medians = phase_dp_train(torch, comm)
    launches.update(dp_launches)
    slice13["dp_overlap"] = phase_dp_overlap(torch, comm, dp_medians,
                                             bucket_rows)
    slice13["dp_async"] = phase_dp_async(torch, mt)
    slice16["ctx_list"] = phase_ctx_list(torch, mt, comm, ck)
    slice19["comm_table"] = phase_comm_table(torch, comm)
    torch.cuda.empty_cache()
    slice21 = {}
    slice21["verify"], audit_ex = phase_verify(torch, mt)
    slice21["program_audit"] = phase_program_audit(torch, mt, audit_ex)
    del audit_ex
    gc.collect()
    torch.cuda.empty_cache()
    slice21["shard_audit"] = phase_shard_audit(torch, comm)
    for name in ("fused_adam", "quant_int8", "quant_twobit",
                 "dequant_sum_int8", "dequant_sum_twobit", "dequant_int8"):
        require(sum(got[name] for got in slice19.values()) > 0,
                f"slice 19's paths launched {name}")
    for name in ("fused_adam", "quant_int8", "quant_twobit",
                 "dequant_sum_int8", "dequant_sum_twobit", "dequant_int8",
                 *FLASH_NAMES):
        require(sum(got[name] for got in slice16.values()) > 0,
                f"slice 16's paths launched {name}")
    mesh_launches = phase_lm_mesh(torch, mt, lm_params)
    del lm_params
    moe_launches = phase_moe_mesh(torch)
    torch.cuda.empty_cache()
    slice22 = {"mxlint": phase_mxlint(torch, mt,
                                      finish_mxlint_cli(mxlint_cli))}
    require(slice22["mxlint"]["fused_adam"] > 0,
            "slice 22's path launched fused_adam")
    torch.cuda.empty_cache()
    slice23 = {"bindings": phase_bindings(torch, mt, bindings_built)}
    torch.cuda.empty_cache()
    slice24 = {"tools_examples": phase_tools_examples(torch, mt)}
    for name in ("int8_matmul", "fused_adam", "quant_twobit",
                 "dequant_sum_twobit", "dequant_twobit"):
        require(slice24["tools_examples"][name] == 0,
                f"slice 24's paths launched no {name}")
    torch.cuda.empty_cache()
    slice25 = {"examples": phase_examples(torch, mt)}
    for name in ("int8_matmul", "quant_int8", "quant_twobit",
                 "dequant_sum_int8", "dequant_sum_twobit", "dequant_int8",
                 "dequant_twobit", *FLASH_NAMES):
        require(slice25["examples"][name] == 0,
                f"slice 25's paths launched no {name}")
    torch.cuda.empty_cache()
    slice26 = {"bench_tools": phase_bench_tools(torch, smi, flash_rows)}
    for name in FLASH_NAMES:
        require(slice26["bench_tools"][name] > 0,
                f"slice 26's paths launched {name}")
    torch.cuda.empty_cache()
    slice27 = phase_bench_subsystems(torch, smi)
    for name in port_kernels():
        require(slice27["kernels"][name] > 0,
                f"slice 27's bench_kernels launched {name}")
    # not on fit's path: twobit gathers in bf16 (comm/allreduce.py)
    launches["dequant_twobit"] = 0
    require(not any(m.split(".")[0] in ("jax", "mxnet_tpu")
                    for m in sys.modules), "the run imported JAX")

    main_row = next(r for r in rows if (r["M"], r["K"], r["N"]) == MAIN_SHAPE)
    kernels = []
    for name, err, row, library_ms in (
            ("int8_matmul", max_err, main_row, main_row["int_mm_ms"]),
            ("fused_adam", adam_err, adam_row, adam_row["library_ms"]),
            *((n, flash_errs[n], r, r["library_ms"])
              for n, r in flash_rows.items()),
            # bitwise equal to their plain versions: no error
            *((n, 0.0, r, r["library_ms"]) for n, r in comm_rows_.items())):
        spec = registry.get_kernel(name)
        kernels.append({
            "name": name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces, "launches": launches[name],
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": library_ms})
        if name == "dequant_twobit":
            kernels[-1]["comm_kernels_phase_launches"] = \
                comm_phase_launches[name]
        if name == "fused_adam":
            # per fit of 8 (train_bf16) and 6 (zoo) steps, one a step
            kernels[-1]["train_bf16_launches"] = {
                tag: got[name] for tag, got in bf16_launches.items()}
            kernels[-1]["zoo_launches"] = {
                tag: got[name] for tag, got in zoo_launches.items()}
        if name in mesh_launches:
            # per mesh, per rank: the steps of phase lm_mesh
            kernels[-1]["lm_mesh_launches"] = mesh_launches[name]
        # per rank: the steps of phase moe_mesh, which runs no kernel
        kernels[-1]["moe_mesh_launches"] = moe_launches[name]
        # the slice 10 phases, each read around its own main path
        kernels[-1]["slice10_launches"] = {p: got[name]
                                           for p, got in slice10.items()}
        # the slice 11 phases, counted by replay
        kernels[-1]["graphs_launches"] = graphs_launches[name]
        kernels[-1]["ckpt_launches"] = ckpt_launches[name]
        # the slice 12 paths: the captured remat fits (counted by replay)
        # and io_native's fit from the JPEG shard, each read around itself
        kernels[-1]["slice12_launches"] = {p: got[name]
                                           for p, got in slice12.items()}
        # the slice 13 paths, each read around itself: the mixed JPEG
        # shard's epoch, the overlapped fits (rank 0, int8 and twobit
        # together) and the dist_async fit (the host updates: no kernel)
        kernels[-1]["slice13_launches"] = {p: got[name]
                                           for p, got in slice13.items()}
        # the slice 14 path: the arithmetic-coded shard's epoch
        kernels[-1]["slice14_launches"] = {p: got[name]
                                           for p, got in slice14.items()}
        # the slice 16 paths, each read around itself: the captured LM
        # steps (by replay) and the replicas' in-process exchanges
        kernels[-1]["slice16_launches"] = {p: got[name]
                                           for p, got in slice16.items()}
        # the slice 17 path: the observed fit (counted step, warm-up,
        # replays and the profile window's eager steps alike)
        kernels[-1]["slice17_launches"] = {p: got[name]
                                           for p, got in slice17.items()}
        # the slice 19 paths, each read around itself: the guarded fit
        # (by replay) and the profiled overlapped fits (rank 0, int8 and
        # twobit together)
        kernels[-1]["slice19_launches"] = {p: got[name]
                                           for p, got in slice19.items()}
        # the slice 20 paths, each read around itself: the elastic fit
        # over its three worlds and the controller's fit (eager replicas)
        kernels[-1]["slice20_launches"] = {p: got[name]
                                           for p, got in slice20.items()}
        # the slice 21 paths, each read around itself: the binds, the
        # program audit and the audited fits (rank 0, int8 and twobit
        # together, the audit's step included)
        kernels[-1]["slice21_launches"] = {p: got[name]
                                           for p, got in slice21.items()}
        # the slice 22 path: the timing fixtures of phase mxlint (replays
        # of the captured fused_adam step)
        kernels[-1]["slice22_launches"] = {p: got[name]
                                           for p, got in slice22.items()}
        # the slice 23 path: the C API's ResNet-50 steps on the card, the
        # embedded host and the native predictor (cuBLAS, cuDNN and the
        # host's CPU: no hand-written kernel)
        kernels[-1]["slice23_launches"] = {p: got[name]
                                           for p, got in slice23.items()}
        # the slice 24 path: elastic_train's fit over [gpu(0)] * 8 (rows
        # 3, 5, 7), train_long_lm's four ranks summed (the flash kernels),
        # the tools and the launched workers' run (their own processes)
        kernels[-1]["slice24_launches"] = {p: got[name]
                                           for p, got in slice24.items()}
        # the slice 25 path: the fifteen single-process examples, each read
        # around its own run (fused_adam: lstm_bucketing's batches)
        kernels[-1]["slice25_launches"] = {p: got[name]
                                           for p, got in slice25.items()}
        # the slice 26 path: the six measurement tools, each read around
        # its own run (the flash kernels: bench_flash's sweep and
        # bench_longctx's steps)
        kernels[-1]["slice26_launches"] = {p: got[name]
                                           for p, got in slice26.items()}
        # the slice 27 path: the thirteen subsystem benches, each read
        # around its own run (bench_kernels: its roofline rows and the
        # exchange on the kernel path; elastic, ckpt, lockwatch and
        # controller: their replicas' eager steps)
        kernels[-1]["slice27_launches"] = {p: got[name]
                                           for p, got in slice27.items()}
        if name in bucket_rows:
            # one 4 MB bucket's shapes; launches on the overlap path
            kernels[-1]["bucket_shape"] = bucket_rows[name]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
