#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and passed over;
every sweep's report must count no kernel fallback, ``n_kernel_fallbacks
== 0``, but the one phase 11 forces):

  1. Build the six CUDA kernels (seven sources: flash_attention has a
     bf16 and an fp32 kernel) from ``src/repro_torch/kernels/csrc`` with
     nvcc (sm_90a; ptxas register/shared-memory report printed; the
     library's build time on a line of its own) and print the card's
     name and power limit.
  2. Hold each kernel against its plain PyTorch version on the card.  The
     BCSR kernels: at edge shapes (bs in {32, 64, 96, 128}, bs not dividing
     n, empty block rows and cols, one block row of 44 blocks beside empty
     ones, nnzb == 0, k in {1, 3, 4, 5, 8, 9, 12, 16, 33, 64}, r in {1, 4},
     shared data with r operand members), to a relative Frobenius error
     <= 1e-5 and max |diff| <= 1e-4 * max |ref| (the kernels and the
     plain version sum in different orders); empty block rows and cols
     exactly zero; bcsr_xa_xta's XA and XTB bit-identical across two
     calls.
     bcsr_xa_xta then on the sweep's operands (r = 4 members, m = 8, n =
     131072, bs = 128, 13.1 GB of stored blocks, B1 = B2 = A) at k = 4 and
     5, the largest rank of each of its builds (4 and 8 columns) that the
     sweep runs, and at k = 8, the shape earlier PRs reported, held, XA
     and XTB compared across two calls, and timed; the kernels line
     reports k = 5.
     bcsr_spmm at that shape with k = 8.  Times kernel, plain version and,
     for bcsr_spmm, the ``torch.sparse_bsr_tensor @ B`` yardstick with CUDA
     events.
     score_topk: n in {1, 5, 1000, 3000}, b in {1, 32, 128}, k in {3, 32},
     topk in {1, 10, 32, 33, 100, 257, 1024} (every list width the kernel
     builds, and its boundaries), held as a top-k (``topk_check``), and
     exact-tie cases (integer factors, rows of A repeated; n = 500, and
     n = 40000, where chunks hold several tiles; topk up to 100) whose
     indices must equal the plain version's.  Timed at the serving-scale
     shape b = 128, n = 4194304, k = 32, topk = 32 (the seeded path: a
     first launch over n / 16 rows, then the full one) beside the plain
     version and the ``torch.topk(V @ A.T, topk)`` yardstick, with each
     stage's device time per call from ``torch.profiler``; the same at
     the serve path's shape (b = 32, n = 131072, k = 3, topk = 10) on
     random factors.
     fused_xa_xtb: n1 != n2 with n in {1, 37, 333, 700, 1000, 1100,
     2600} (no tile multiple; several panels and chunks, so both partial
     reductions), m = 1 (the sliced schedule's call, a slice view of X),
     k in {1, 3, 5, 10, 16, 24, 64}, r in {1, 4}, B2 broadcast over m
     (stride 0), n2 odd and n2 % 4 == 0 (the cp.async and the TMA path),
     to the BCSR kernels' tolerances, XA and XTB bit-identical across two
     calls; then held (and compared across two calls) and timed beside
     its plain version (two batched products), its bound and the cuBLAS
     pair X @ B1, X^T @ B2 (a yardstick of reading X twice) on the grid
     sweep's operands (r = 4, m = 8, n = 16384, X 34.4 GB, B1 = A, B2 = A
     broadcast over m) at k = 4, 5 (the sweep's largest ranks), 8 and 10
     (the paper's), and one slice of it at k = 4; the kernels line
     reports k = 5.
     mu_update_a: n in {0, 1, 37, 1000}, k in {1, 3, 5, 16, 64}, r in
     {1, 4}, S per member or shared (stride 0), padded cells whose masked
     columns must stay exact zeros, and k = 65 refused; then held and timed
     beside its plain version at the BCSR sweep's shape (r = 4, n =
     131072, k = 5) and the dense sweeps' (r = 4, n = 16384, k = 5), per
     call for both shapes first, then its device time per launch from
     ``torch.profiler``; the kernels line reports the dense shape.
  3. Run the RESCALk sweep through the CLI's own entry point
     (``repro_torch.launch.rescalk_run.main``) at full size on a seeded
     planted COO file: n = 131072 entities, m = 8 relations, bs = 128, the
     diagonal blocks plus 0.5% of the off-diagonal ones, ~2% of each
     stored block's entries per relation (~16M triples, ~3.3 GB of
     stored blocks), k = 2..5, r = 4 members, --use-fused-kernel.  The
     kernels' launch counters are zeroed just before and read just after:
     both BCSR kernels must have launched, and mu_update_a once per MU
     iteration (1200).  One cut: 300 MU iterations per member
     (the CLI's default; the paper runs 1000).  The regression keeps its
     100 iterations; n, m, bs, the density and r are not cut.
  4. The same sweep with --fused-impl ref (plain PyTorch products on the
     card, the same TorchDraws numbers): the same k_opt, and per-k
     s_min/s_mean/rel_err within 1e-4.
  5. Serve the bundle phase 3 wrote through the serve CLI's entry point
     (``repro_torch.launch.serve.main``): 4096 zipf queries (skew 1.1,
     mixed directions) in 16 requests, batch 32, topk 10.  The
     score_topk counter, zeroed just before, must equal the engine's
     device batches and be above 0.  The first request's latency (the
     engine's one-time set-up) is printed apart from the other 15.
     Again with --impl ref: identical stats(), and every answer of both
     runs passes ``topk_check``.  Then
     score_topk is timed at the serve path's own shape (b = 32, the
     bundle's A) beside its plain version and the yardstick, with each
     stage's device time per call, and the stream is served once more
     under ``torch.profiler`` (the device's idle share and its time by
     kernel).
  6. The dense grid sweep on a 1 x 1 ``torch.distributed`` grid over a
     one-rank NCCL group (``launch.mesh.make_grid``): ``rescalk(X, cfg,
     grid=grid)`` on X from the port's ``synthetic_rescal`` built on the
     card (n = 16384 entities, m = 8 relations, planted k = 4, noise
     0.01, seed 0; 8.6 GB, and 34.4 GB more for the 4 perturbed members),
     k = 2..5, r = 4, 300 MU iterations, 100 regression iterations, the
     batched schedule, use_fused.  n = 16384 is the largest power of two
     whose ensemble one H100 holds; the one cut is the MU iterations (300,
     the CLI's default; the paper runs 1000).  The counters, zeroed just
     before: fused_xa_xtb and mu_update_a must launch once per MU
     iteration (1200 each) and the grid's collective count be above 0.  The same sweep with
     impl="ref": the same k_opt, per-k s_min/s_mean/rel_err within 1e-4.
     Then ``dist_rescal`` with the sliced schedule at the same n for 20
     iterations (m launches per iteration), kernel and ref, A and R within
     1e-4 of the largest |value|.  The group is destroyed at the end.
  7. The CLI's default path, ``rescalk_run.main`` without --data: the
     dense sweep on one device on the synthetic tensor it builds on the
     card, ``--n 16384 --m 8 --k-true 4 --k-min 2 --k-max 5 --r 4 --iters
     300 --use-fused-kernel`` (phase 6's X and draws: X 8.6 GB, the 4
     members 34.4 GB).  The counters, zeroed just before: fused_xa_xtb
     and mu_update_a once per MU iteration (1200 each); k_opt = 4, the
     planted rank; per-k values within 1e-4 of phase 6's grid sweep.  The
     same run with --fused-impl ref (no launches), and with --mode grid
     --grid-chunk 4 (4 padded cells per chunk, 34.4 GB, where the whole
     16-cell grid would need 137 GB): the same k_opt, per-k within 1e-4
     of the batched run.  Then at n = 4096 (an exact eigh of an (n, n)
     surrogate per member, and a member loop, are why these run smaller)
     the batched run, --mode loop, --schedule sliced and --init nndsvd:
     the kernels launched and the same k_opt as the batched run.
  8. LM serving, the dense decoder through flash_attention: bf16 runs
     the tensor-core kernel (variant ``sm90_bf16``, wgmma and a TMA
     ring), fp32 the FMA kernel (``fma_fp32``), each case through its
     dtype's variant (per-variant counters).  The kernels against their
     plain version (``ref_attention``) on permuted (B, S, H, D) views
     over FLASH_CHECK: fp32 and bf16, d in {16, 32, 64, 128},
     (hq, hkv) in {(4, 4), (8, 2), (5, 1), (32, 8)}, causal or not,
     q_offset 0 and 64, sq in {1, 37, 256, 1000} x skv in {37, 1000,
     4096}; fp32 to REL_TOL / ABS_TOL, bf16 to BF16_REL_TOL /
     BF16_ABS_TOL against the plain version in bf16 and on fp32 copies.
     Timed (bf16, causal) at the LM cell's prefill shape (b = 4, hq = 32,
     hkv = 8, s = 4096, d = 64; the kernels line) and at one 32k sequence,
     beside its plain version, its bound (TFLOP/s and the share of the
     bound printed) and the ``scaled_dot_product_attention`` yardstick.  Then llama3.2-1b at full
     width in fp32 (seeded init): one prefill of 2 x 1024 through the
     kernel and one through the plain chunked path, 16 launches, logits
     and caches within LM_F32_TOL.  Then the slice through the CLI's entry
     point (``repro_torch.launch.decode_demo.main``), llama3.2-1b at full
     width in bf16, --batch 4 --prompt-len 4096 --new-tokens 16 (after a
     short warm-up run): the counters, zeroed just before, show one
     tensor-core flash_attention launch per layer (16) and no other
     kernel; prefill
     and decode times, tok/s and peak device memory are printed.  The
     same prompts through the plain chunked path: last-position logits,
     and each decode step's logits when fed the kernel path's tokens,
     within LM_BF16_TOL.  Last, the prefill and 16 decode steps under
     ``torch.profiler`` (device idle share, time by kernel, attention's
     share of the prefill).  The cut
     against ``repro``'s prefill_32k shape (B = 32 x 32768): B = 4 x 4096.
  9. Telemetry (run after phase 5, in the same temporary directory):
     phase 3's sweep again through ``rescalk_run.main``, on phase 3's
     file at full width (n = 131072, m = 8, bs = 128, k = 2..5, r = 4,
     the fused kernels), untraced and then with ``--trace DIR
     --sanitize``; the one cut is 30 MU iterations (TRACE_ITERS).
     ``scripts/check_trace.py DIR --report R --expect-metrics
     --expect-memory`` must exit 0 (a subprocess);
     memory.json's peak_device_bytes (the allocator's peak is reset just
     before the traced run) must be at least the resident
     operand, every per-rank entry measured with peak >= each of its
     parts, and every unit a positive device peak; metrics.npz's
     rel_error trajectory holds 4 ranks x 30 iterations x 4 members
     points; bcsr_xa_xta, bcsr_spmm and mu_update_a launched (counters
     zeroed just before), the report's mu_update_a count one per MU
     iteration; the same k_opt as the untraced run, per-k values within
     1e-4 (at 30 iterations the selection can differ from phase 3's).
     The span summary, the cost table (achieved GFLOP/s per unit against
     the paper's model) and the traced ms per MU iteration beside the
     untraced run's (and phase 3's beside RECORDED_BCSR_MS) are
     printed, then one k = 5 MU iteration at the sweep's shape untraced
     and traced (CUDA events) and the traced one's device time by kernel
     (torch.profiler).  Then phase 5's stream through
     ``serve.main``, untraced and then with ``--trace DIR2``:
     check_trace.py exits 0, one serve/request span per request, one
     serve/score span and one score_topk launch per device batch, the
     same stats() as phase 5; the spans' times, each request's latency
     and the q/s of both runs are printed beside phase 5's; then
     TRACE_ROUNDS rounds of the stream untraced, traced to a file, traced
     in memory and untraced (each with phase 5's stats()), their request
     p50s, and the host time of one trace record, written to a file and
     in memory.
 10. The sharded and virtual sparse operand (after phase 7, in the same
     temporary directory; the card's name and power limit printed
     first).  (a) The virtual BCSR sweep through
     ``rescalk_run.main`` at full width: ``--data virtual:bcsr:n=131072,
     m=8,k=4,bs=128,density=0.005,seed=0 --k-min 2 --k-max 6 --r 4
     --iters 300 --use-fused-kernel`` (nb = 1024, ~6100-6300 stored
     blocks, ~3.2 GB resident, 512 GiB logical); the manifest's logical
     and resident bytes held to the spec's; the counters, zeroed just
     before: both BCSR kernels launched, mu_update_a once per MU
     iteration (1500); the same run with --fused-impl ref: the same
     k_opt, per-k within 1e-4.  The selected k against the planted 4,
     the per-k table, ms per MU iteration beside phase 3's, and the
     device peak are printed; rank recovery is a finding, not a
     requirement.  (b) The same operand (``virtual_sharded_bcsr``,
     generation seconds printed) on a 1 x 1 NCCL grid: ``rescalk(cell,
     cfg, grid=grid)`` fused, bcsr_xa_xta and mu_update_a once per MU
     iteration, collectives > 0, the same k_opt as (a) and per-k within
     1e-4 of it; then ``dist_rescal`` on the shard with the sliced
     schedule for 20 iterations (m launches per iteration), kernel and
     ref, A and R within 1e-4 of the largest |value|.  (c) Phase 3's
     file through ``partition_coo(grid=2)`` on the card (balance, shard
     nnzb, z_max, resident bytes and seconds printed); ``to_bcsr()``
     holds phase 3's stored-block count and sum; each front-padded shard
     through bcsr_xa_xta and bcsr_spmm at k = 4 and 5 against their
     plain versions (phase 2's tolerances), timed with and without its
     padding; then ``manifest_of`` of the skewed spec
     ``virtual:bcsr:n=131072,m=8,k=4,bs=128,grid=2,density=0.005,
     skew=1.2,seed=0`` (index only), its shard nnzb and identity-layout
     imbalance.  (d) ``virtual:bcsr:n=4096,m=3,k=4,bs=128,density=0.05,
     seed=0`` through the CLI (k = 2..6, r = 4, 300 iterations, fused):
     k_opt must be the planted 4.  Phase 2's edge cases include
     front-padded patterns (300 repeated (0, 0) blocks before the real
     ones).
 11. Checkpoints, retry and faults (after phase 10, in the same temporary
     directory; the card's name and power limit printed first), on phase
     10's operand at k = 2..5, r = 4, 30 MU iterations (phase 9's cut).
     (a) Through ``rescalk_run.main`` in this process, the counters zeroed
     just before each run and read just after: the sweep under
     ``torch.use_deterministic_algorithms(True, warn_only=True)``, which
     must warn of nothing (both BCSR kernels launched, mu_update_a once per
     MU iteration); the same sweep with ``--ckpt-dir``; and its resume,
     which reuses every unit.  All three reports are bit-identical (ks,
     curves, k_opt, units) with ``n_kernel_fallbacks == 0``.  Printed:
     each unit's checkpoint bytes, save and restore seconds, and the ms
     per MU iteration with and without the checkpoints.  (b)
     ``scripts/torch_chaos_drill.py --device cuda`` on the same sweep, one
     CLI process per run: a baseline and a second fault-free run
     (identical reports: determinism end to end), a transient unit fault
     (retried, identical report), a torn checkpoint write and the resume
     that quarantines it (identical), a deterministic fault (fails fast
     after one attempt), one forced ``kernel/dispatch`` budget-overflow
     (the call is refused with a TransientError and its unit retries on
     the kernel: one ``kernel/fallback`` event with ``chosen="retry"``,
     ``n_kernel_fallbacks == 1``, attempts == 2, identical report), and
     an ``--async-ckpt`` run killed with SIGKILL once the first unit's
     LATEST exists, whose resume reuses the saved units and equals the
     baseline.  Every traced phase passes ``scripts/check_trace.py
     --report``; every report but the forced overflow's has
     ``n_kernel_fallbacks == 0`` and launched both kernels.  Then phases
     3, 6, 7 and 10's ms per MU iteration beside the ones PERF.md
     records for the previous release of this script.
 12. The sweep on the process grid as ``repro`` runs it on its mesh (after
     phase 11, in the same temporary directory; the card's name and power
     limit printed first), on one 1 x 1 NCCL grid (``make_grid(data=1,
     model=1)``, destroyed at the end), ``SweepScheduler(cfg, grid=grid)``
     with the counters zeroed just before each sweep and read just after,
     k = 2..5, r = 4, the fused kernels; the one cut is 30 MU iterations
     (phases 9 and 11's).  (a) Phase 6's dense operand (n = 16384, m = 8,
     planted k = 4, noise 0.01, seed 0; X 8.59 GB, a unit's 4 members
     34.36 GB): the per-k sweep, fused_xa_xtb and mu_update_a once per MU
     iteration; with ``ckpt_dir`` and ``stop_after_units=2``
     (SweepInterrupted) and its resume, which reuses 2 units and equals
     the per-k sweep bit for bit; then ``mode="grid", grid_chunk=4`` (4
     chunks of 4 k_max-padded cells), the kernels once per MU iteration
     per chunk, the same k_opt and per-k values within 1e-4 of the per-k
     sweep, and every cell of every chunk checkpoint exactly 0 past its
     k.  (c) The per-k sweep again under a fault plan: a transient
     ``sched/unit`` fault on the first unit and a ``budget-overflow`` on a
     ``kernel/dispatch`` call in the middle of the second (the call is
     refused with a TransientError, counted once with
     ``chosen="retry"``; no plain version runs): the report equals the
     fault-free one bit for bit, and those two units took 2 attempts.  (b)
     Phase 10's operand (``virtual_sharded_bcsr``, ``cell(0, 0)``: 6122
     stored blocks, 3.21 GB): the per-k sweep and the cross-k sweep
     (``grid_chunk=4``), bcsr_xa_xta and mu_update_a once per MU iteration
     per unit or chunk, bcsr_spmm launched, the same k_opt and per-k
     within 1e-4; the cross-k sweep with ``ckpt_dir`` stopped after one
     chunk and resumed equals it bit for bit, its masked columns exactly
     0.  Printed: ms per MU iteration per k and cross-k beside phases 6
     and 10 (b)'s, each checkpoint's bytes, save and restore seconds,
     collectives per unit and the agreements among them, the device
     peak.
 13. LM training (after phase 12, in the same temporary directory; the
     card's name and power limit printed first), llama3.2-1b at its
     published widths (16 layers, d_model 2048, 32/8 heads, d_ff 8192,
     vocab 128256; bf16 parameters, fp32 AdamW moments, random init from
     seed 0) on ``data.tokens.batch_at`` batches of train_4k's sequence
     (4096) with the global batch cut from 256 to 4, ``--remat``.  The
     counters are zeroed just before each run and read just after: the
     train path launches no kernel (the attention backward is the plain
     chunked path's, as in ``repro``).  (a) ``launch.train.main``
     (``--steps 8 --batch 4 --seq 4096 --remat --device cuda``) under
     ``torch.use_deterministic_algorithms(True)``: every loss and
     grad_norm finite, the mean loss of the last 4 steps below the first
     4's; ms per step after the first, tokens/s, the model-FLOPs share of
     the 989 TFLOP/s bf16 peak and the device peak printed.  (c)
     ``make_train_step(microbatches=2)`` against one batch from the same
     state: loss and grad_norm within TRAIN_MB_TOL.  (d) a forward with
     impl="cuda" under grad raises.  (b) under deterministic algorithms,
     5 steps with ``ckpt_dir``, save_every 3 and a raise-transient fault
     on ``train/step`` hit 4, which restores step 3 and replays: every
     loss equals that of the same step of (a), the uninterrupted run (the
     same stream, seed, lr and remat), bit for bit; the checkpoints'
     bytes, save and restore seconds printed.  Then one step under
     torch.profiler (idle share, time by kernel class) and its parts alone
     (chunked attention per layer, CE, clip + AdamW).  (e)
     ``examples/torch_trade_nations.py`` and ``torch_quickstart.py`` with
     ``--device cuda`` (their k_opt printed; fused_xa_xtb and mu_update_a
     launched), and ``rescalk(X, cfg, member_runner=...)`` with a runner
     that wraps ``default_member_runner`` on the trade tensor (n = 24, m =
     12, planted k = 3): fused_xa_xtb and mu_update_a once per MU
     iteration (4800), the k_opt and per-k values of loop mode within
     1e-4.
 14. The LM zoo's other families at their published widths and depths
     (after phase 8; the card's name and power limit printed first),
     bf16, random weights from seed 0.  flash_attention at the two call
     shapes beyond the dense decoders', written as the models write them
     and passed as permuted views: minicpm3-4b's MLA (b = 2, h = 40, s =
     2048, q/k 96 and v 64 columns zero-padded to 128, scale 96 ** -0.5,
     causal) and whisper-large-v3's cross attention (b = 2, h = 20, sq =
     512, skv = 2048, d = 64, non-causal), each against its plain
     version within ZOO_TOL (the padded output columns exactly 0) and
     timed beside it, one scaled_dot_product_attention call on the
     unpadded tensors, and the bound of the function's own widths (the
     padded widths' bound beside it).  Every served run below follows a
     warm-up at its own batch and prompt (2 tokens, unchecked).  (a)
     deepseek-moe-16b (28 layers, d_model 2048, 16 heads of 128, 64
     routed experts top-6 + 2 shared, d_ff 1408, vocab 102400; 16.67B
     parameters, 33.34 GB) through ``decode_demo.main`` (--batch 4
     --prompt-len 4096 --new-tokens 16, ``moe_impl="einsum"``), the
     counters zeroed just before and its expert choices recorded
     (``RouteTape``): 28 ``sm90_bf16`` launches in the prefill and no
     other kernel; prefill ms and tok/s, decode ms per step, the device
     peak.  Then against the plain chunked path (``demo_vs_plain``): the
     router's top-6 is discrete, so a bf16 rounding difference in
     attention flips near ties and the flips carry through the layers;
     the plain path is run on the run's recorded choices: last-position
     logits and every decode step's logits fed the run's tokens within
     ZOO_TOL.  On its own routing the kernel path's last-position error
     and share of flipped (token, layer) top-6 sets must be within
     ZOO_FREE_SLACK of a path with no kernel (``SdpaAttention``:
     scaled_dot_product_attention in the kernel's place); printed: both,
     the flipped share per layer, the first MoE layer's router margins
     (all tokens, flipped tokens), and the assignments dropped past
     capacity and the busiest expert's load per layer.  Then the
     prefill and 8 decode steps under ``torch.profiler``.  (b)
     minicpm3-4b, granite-moe-3b-a800m, mamba2-1.3b and hymba-1.5b through
     ``decode_demo.main`` (--batch 2 --prompt-len 2048 --new-tokens 8),
     whisper-large-v3 (2048 frames, 512 tokens) and internvl2-26b (256
     patches, 1792 tokens) through ``decode_demo.serve`` on a built
     model (the demo refuses enc-dec and VLM, as ``repro``'s): each with
     its flash_attention launches per variant (62, 32, 0, 0, 96 and 48,
     all ``sm90_bf16``), no other kernel, and the plain path within
     ZOO_TOL (granite-moe held as deepseek-moe-16b in (a)).  Depth
     is not cut; the cuts are the batch and the sequence (PERF.md §4).
 15. The LM on the process grid (after phase 14; the card's name and
     power limit printed first), llama3.2-1b at its published widths in
     bf16, weights from seed 0 and prompts from seed 1 (decode_demo's).
     (a) A 1 x 1 NCCL LM grid (``make_lm_grid(data=1, model=1)``,
     destroyed at the end), the model placed on it
     (``params_shardings``): ``decode_demo.serve(model, prompts, 32,
     grid=grid)`` at 4 x 4096 after a short warm-up, the counters
     zeroed just before: 16 ``sm90_bf16`` launches and no other kernel;
     then the single-device path on the same weights fed the grid's
     tokens: last-position and step logits within GRID_ONE_TOL, every
     greedy token equal; the collectives of a grid prefill and of a
     decode step, prefill and decode times and the device peak printed.
     3 grid train steps (``make_train_step(cfg, grid=grid)``, ZeRO-1
     state from ``init_state(grid=)``) at 4 x 4096 with remat on
     ``batch_at`` batches, after 3 single-device steps from the same
     seed and batches: each loss within GRID_LOSS_TOL, the parameters
     after the last step within 2 * lr per step, no kernel launched; the
     collectives per step, ms per step and both device peaks printed.
     ``ef_psum`` on a CUDA tensor equals its plain formula (the int8
     round trip of g + err, on a group of one).  (b) A 1 x 2 LM grid of
     two spawned processes on the one card, gloo on CUDA tensors
     (``spawn_grid(..., device="cuda")``; NCCL refuses two ranks on one
     GPU), tensor parallel over "model": ``decode_demo.serve`` at 2 x
     2048 and 16 tokens on each rank: 16 ``sm90_bf16`` launches per rank
     on 16 query and 4 KV heads (every call's heads recorded), both
     ranks' tokens equal; against the single-device path fed the
     grid's tokens (in this process): logits within LM_BF16_TOL,
     greedy tokens equal in at least GRID_TP_SAME of the steps; the
     collectives per prefill and per decode step, times and each rank's
     device peak printed.  The cuts: prefill_32k's 32 x 32768 to 4 x
     4096 and train_4k's batch 256 to 4 ((a)), 2 x 2048 ((b)); depth and
     widths are not cut (PERF.md §4).
 16. The LM zoo's other families on the process grid (after phase 15;
     the card's name and power limit printed first), at their published
     widths and depths in bf16, weights from seed 0 and prompts from
     seed 1 (decode_demo's).  (a) deepseek-moe-16b: the single-device
     path first (``decode_demo.serve`` at 4 x 4096 and 16 tokens after
     a warm-up, its routing recorded; only its logits and tokens kept),
     then the model placed on a 1 x 1 NCCL LM grid and served there
     (``serve(..., grid=grid)``, counters zeroed just before): 28
     ``sm90_bf16`` launches and no other kernel; its logits within
     GRID_ONE_TOL of the single device's and every greedy token equal,
     on its own routing, or else fed the single device's tokens on its
     recorded routing (``RouteTape``); the flipped share of the
     prefill's top-6 sets, the collectives per prefill and per decode
     step, the times and the peak printed.  (b) A 1 x 2 grid of two
     processes on the card (gloo on CUDA tensors): granite-moe-3b-a800m
     (20 experts per rank) and minicpm3-4b (20 MLA heads per rank,
     padded to 128) at 2 x 2048 and 8 tokens, each served on its own
     routing (32 and 62 ``sm90_bf16`` launches per rank, every call's
     heads recorded) and then fed the single device's tokens (run first
     in this process; the MoE on its recorded routing, handed to each
     rank): logits within LM_BF16_TOL and at least GRID_TP_SAME of the
     greedy tokens equal; then 2 granite-moe train steps at 2 x 1024
     with remat, each step's loss and grad norm against the single
     device's 2 steps from the same seed-0 state and batches (run first
     in this process): within GRID_LOSS_TOL at the first step and
     GRID_ZOO_UPDATED_TOL after the first update; no kernel launched; ms per step,
     collectives and each rank's peak printed.  The cuts: phase 14's (PERF.md §4).
 17. One rank's share of the paper's exascale cells (after phase 16; the
     card's name and power limit printed first), on a 1 x 1 NCCL grid
     (``make_grid(data=1, model=1)``, destroyed at the end), through
     ``dist/engine.py`` ``make_mu_step`` with the fused kernel policy at k
     = 10, at the local shapes the dry run's plan gives one rank of the
     16 x 16 grid (``launch.dryrun.rescal_share``), seeded uniform values.
     (a) rescal-dense-3tb, batched: X^(i,j) (20, 12288, 12288) fp32, 12.08
     GB, 3,019,898,880 floats (past 2^31), through ``fused_xa_xtb`` and
     ``mu_update_a``.  (b) rescal-sparse-eb, sliced: n_loc = 23,347,200
     (nb_loc = 182,400 block rows), 6653 stored blocks of 128^2 per slice
     at seeded uniform positions (local density 2.0e-7), m = 20, 8.72 GB
     of blocks, A^(i) (23,347,200, 10) 0.93 GB, through ``bcsr_xa_xta``
     (one launch per slice) and ``mu_update_a``.  For each share: one MU
     iteration against the plain path (``KernelPolicy(impl="ref")``) on
     the same inputs, A and R within phase 2's tolerances; then
     EXA_ITERS MU iterations with the counters and the allocator's peak
     reset just before, timed by CUDA events (ms per MU iteration
     printed), each kernel launched (one ``fused_xa_xtb`` or one
     ``bcsr_xa_xta`` per slice, one ``mu_update_a`` per iteration), the
     collectives per iteration equal to the plan's,
     ``torch.cuda.max_memory_allocated`` within EXA_PEAK_TOL of the 1 x 1
     plan's total at the share's shapes, and the step's own allocations
     (that peak less ``torch.cuda.memory_allocated`` just before the
     timed loop) within EXA_PEAK_TOL of the plan's output + temp; the 16
     x 16 plan's total is printed beside it, term by term.  (b)'s
     relative error after the iterations through ``local_rel_error_bcsr``
     (one ``bcsr_spmm`` launch) against the plain path's within 1e-4, its
     peak printed; then the (20, 23,347,200, 10) product X_t A itself
     (4.67e9 outputs, past 2^31), one ``bcsr_spmm`` launch held against
     the plain segment sum EXA_SPMM_SLICES slices at a time at phase 2's
     tolerances (a launch made for the comparison, not counted).
     Then the dry run's plan of phases 8, 13 and 14's LM cells
     (llama3.2-1b serve at 4 x 4112 positions, its training at 4 x 4096
     with ``--remat``, deepseek-moe-16b serve at 4 x 4112), each on a 1 x 1
     grid, beside the peak that phase measured in this run: the plan's
     state terms (parameters, gradients, moments, cache, batch) must not
     exceed it, and its total with the fit's margin
     (``dryrun.LM_PLAN_SHORTFALL``) must reach it; the total's ratio to it
     is printed.  The kernels line's
     launches of the four RESCAL kernels are this phase's.
 18. The counted step (``launch.step_costs``), inside phases 8 and 17
     while their operands are resident: one MU iteration of each of
     phase 17's two shares, and llama3.2-1b's 4 x 4096 prefill and one
     decode step on phase 8's model, counted on the card under a
     ``StepCounter``; each count must equal the count of the same step on
     meta tensors (``dryrun.count_rescal`` on a 1 x 1 recording grid; the
     model rebuilt on meta) exactly, in flops, bytes, collectives and the
     op histogram.  Printed beside the card's name and power limit:
     counted GFLOP and GB, the phase's own timed ms (phase 17's ms per MU
     iteration; phase 8's prefill and decode ms per step), the achieved
     TFLOP/s and TB/s, and the roofline share max(flops / the type's
     peak, bytes / PEAK_BYTES_PER_S) / ms (fp32's peak for RESCAL,
     bf16's for the LM); a share above ROOFLINE_MAX fails (the count
     missed work).

Printed last, each on a line of its own: ``{"kernels": [...]}``, the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them, and ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the port's sources beside it, the
script exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import statistics
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The card's published peaks (H100 SXM data sheet): HBM bandwidth and
# fp32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

REL_TOL = 1e-5        # relative Frobenius error, kernel vs plain version
ABS_TOL = 1e-4        # max |diff| / max |ref|
SWEEP_TOL = 1e-4      # per-k s_min / s_mean / rel_err, kernel vs ref sweep
# score_topk: scores against the plain version's and against float64
# recomputation, relative to the row's largest |score| (fp32 sums of k
# terms in another order differ by a few ulps)
TOPK_TOL = 1e-5

FULL = dict(n=131072, m=8, bs=128, off_density=0.005, fill=0.02,
            k_min=2, k_max=5, r=4, iters=300, seed=0)
# bcsr_xa_xta on the BCSR sweep's operands: ranks 2..4 run the kernel's
# 4-column build and rank 5 its 8-column build, so each is timed at its
# largest rank in the sweep (the kernels line reports k = 5); k = 8 is the
# shape earlier PRs reported
BCSR_KS = (4, 5, 8)
# the serve phase's stream, and score_topk's serving-scale timing shape
SERVE = dict(queries="random:4096:1.1", batch=32, topk=10, requests=16,
             mode="mixed", seed=0)
TOPK_SCALE = dict(b=128, n=4194304, k=32, topk=32)
# score_topk at the serve path's shape on random factors (phase 5 times it
# on the bundle's)
TOPK_SERVE = dict(b=32, n=131072, k=3, topk=10)
# the dense grid sweep (phase 6), and fused_xa_xtb's timing shape
GRID = dict(n=16384, m=8, k_true=4, noise=0.01, seed=0, k_min=2, k_max=5,
            r=4, iters=300, regress_iters=100, sliced_iters=20, sliced_k=4)
# fused_xa_xtb on the grid sweep's operands: k = 4 and 5 (the sweep's
# largest ranks), 8 (one full n8 tile) and 10 (the paper's rank, two n8
# tiles); the kernels line reports k = line_k, the sweep's k_max; the
# sliced schedule's one-slice call is timed at sliced_k
FUSED_SCALE = dict(r=4, m=8, n=16384, ks=(4, 5, 8, 10), line_k=5,
                   sliced_k=4)
# mu_update_a at the BCSR sweep's and the dense sweeps' shapes (A (r, n,
# k) at k = k_max); the kernels line reports the dense one
MU_SCALES = (dict(r=4, n=131072, k=5), dict(r=4, n=16384, k=5))
# phase 8: flash_attention's check grid (inputs as permuted (B, S, H, D)
# views), its timing shapes (the LM cell's prefill and one 32k sequence;
# the kernels line reports the first), and the LM serve cell
FLASH_CHECK = dict(b=2, dtypes=("float32", "bfloat16"),
                   dims=(16, 32, 64, 128),
                   heads=((4, 4), (8, 2), (5, 1), (32, 8)), q_offsets=(0, 64),
                   sq=(1, 37, 256, 1000), skv=(37, 1000, 4096))
FLASH_SCALES = (dict(b=4, hq=32, hkv=8, s=4096, d=64),
                dict(b=1, hq=32, hkv=8, s=32768, d=64))
LM = dict(arch="llama3.2-1b", batch=4, prompt=4096, new_tokens=16,
          parity_batch=2, parity_len=1024)
# bf16 flash_attention against the plain version: the kernel rounds p to
# bf16 for p @ v, per 128-key tile, and the output to bf16
BF16_REL_TOL = 1e-2   # relative Frobenius error
BF16_ABS_TOL = 2e-2   # max |diff| / max |ref|
# the model's logits and caches, kernel path vs plain chunked path: fp32
# differs by summation order through 16 layers; bf16 also rounds p at
# other tiles (64 keys against 1024) and every activation after it
LM_F32_TOL = 1e-4
LM_BF16_TOL = 5e-2
# the card's published bf16 dense tensor-core peak (H100 SXM data sheet)
PEAK_BF16_FLOP_PER_S = 989e12
# the CLI's default path (phase 7): the dense single-device sweep at the
# grid sweep's size, and the modes whose member loop or exact eigh of an
# (n, n) surrogate per member make them run smaller
DENSE = dict(n=16384, m=8, k_true=4, k_min=2, k_max=5, r=4, iters=300,
             grid_chunk=4, small_n=4096)
# phase 9: the traced BCSR sweep's one cut (FULL runs 300), and phase 3's
# untraced time per MU iteration that PERF.md records for this script on
# NVIDIA H100 80GB HBM3 at 700.00 W (the untraced path must not move)
TRACE_ITERS = 30
RECORDED_BCSR_MS = 11.56
TRACE_PROFILE_REPS = 10   # MU iterations per timing of one traced step
TRACE_ROUNDS = 3          # serve rounds: untraced, to a file, in memory


# phase 10: the virtual BCSR sweep at full width ((a) and (b); nb = 1024,
# ~6262 stored blocks, 3.28 GB, 512 GiB logical), the skewed grid-2 spec
# whose manifest (c) prints, and the small spec whose planted rank (d)
# must come back
VIRTUAL = dict(spec="virtual:bcsr:n=131072,m=8,k=4,bs=128,density=0.005,"
                    "seed=0", n=131072, m=8, bs=128, k_true=4, k_min=2,
               k_max=6, r=4, iters=300, sliced_k=4, sliced_iters=20)
VIRTUAL_SKEW = ("virtual:bcsr:n=131072,m=8,k=4,bs=128,grid=2,density=0.005,"
                "skew=1.2,seed=0")
VIRTUAL_SMALL = dict(spec="virtual:bcsr:n=4096,m=3,k=4,bs=128,density=0.05,"
                          "seed=0", n=4096, k_true=4, k_min=2, k_max=6, r=4,
                     iters=300)
PARTITION_GRID = 2          # (c): phase 3's file on a 2 x 2 layout
PADDING_KS = (4, 5)         # (c): the shards through both BCSR kernels

# phase 11: the chaos drill of the CLI at full width on phase 10's operand
# (k = 2..5, 30 MU iterations as phase 9; the one cut), and the ms per MU
# iteration of earlier phases that PERF.md records for the previous
# release of this script on NVIDIA H100 80GB HBM3 at 700.00 W
DRILL = dict(spec=VIRTUAL["spec"], k_min=2, k_max=5, r=4, iters=30)
DRILL_TIMEOUT = 600
RECORDED_MS = {"phase 3": 11.63, "phase 6": 14.39, "phase 7": 14.24,
               "phase 7 grid mode": 17.12, "phase 10 (a)": 11.63,
               "phase 10 (b)": 11.84}
# phase 12: the sweep on a 1 x 1 NCCL grid, resilient and cross-k, at
# phase 6's dense width and on phase 10's operand; the one cut is 60 MU
# iterations (phase 9's and phase 11's)
GRID_SWEEP = dict(n=16384, m=8, k_true=4, noise=0.01, seed=0, k_min=2,
                  k_max=5, r=4, iters=30, regress_iters=100, grid_chunk=4)
# ms per MU iteration of this run, by phase (filled as the phases run)
MS_PER_ITER: dict[str, float] = {}


# phase 13: LM training at llama3.2-1b's published widths, train_4k's
# sequence (4096) with the global batch cut from 256 to 4, --remat
TRAIN = dict(arch="llama3.2-1b", batch=4, seq=4096, steps=8, lr=1e-3,
             restart_steps=5, save_every=3, fault_hit=4, microbatches=2)
# two microbatches against one batch in bf16: each half's loss and
# gradients round to bf16 in another grouping
TRAIN_MB_TOL = 2e-2
# phase 13 (e): the trade examples' tensor and sweep
TRADE = dict(n=24, m=12, k=3, seed=7, k_min=2, k_max=5, r=4, iters=300,
             regress_iters=60)


# phase 14: the LM zoo's other families at their published widths and
# depths, random weights from seed 0, bf16: (a) deepseek-moe-16b served
# through decode_demo (28 layers, 64 routed experts top-6 + 2 shared,
# 16.7B parameters) at batch 4, prompt 4096, 32 new tokens; (b)
# minicpm3-4b (MLA), granite-moe-3b-a800m, mamba2-1.3b and hymba-1.5b
# through decode_demo, whisper-large-v3 and internvl2-26b through its
# serve() on a built model (frames or patches are not tokens); and
# flash_attention at minicpm3-4b's MLA shape (96/64 padded to 128) and
# whisper-large-v3's cross shape
ZOO_SERVE = dict(arch="deepseek-moe-16b", batch=4, prompt=4096,
                 new_tokens=16)
ZOO_PROFILE_STEPS = 8
ZOO_DEMOS = ("minicpm3-4b", "granite-moe-3b-a800m", "mamba2-1.3b",
             "hymba-1.5b")
ZOO_DEMO = dict(batch=2, prompt=2048, new_tokens=8)
ZOO_LIBRARY = {"whisper-large-v3": dict(batch=2, frames=2048, tokens=512),
               "internvl2-26b": dict(batch=2, tokens=1792)}
ZOO_FLASH = (dict(name="MLA", b=2, h=40, sq=2048, skv=2048, d=128, dqk=96,
                  dv=64, causal=True),
             dict(name="cross", b=2, h=20, sq=512, skv=2048, d=64, dqk=64,
                  dv=64, causal=False))
# kernel path against the plain chunked path, bf16 (phase 8's LM_BF16_TOL)
ZOO_TOL = 5e-2
# an MoE model on its own routing: the kernel path's last-position error
# and share of flipped expert sets, against the plain path, each at most
# this times a kernel-free bf16 path's (scaled_dot_product_attention).
# Past the first flipped choice two runs diverge chaotically, so two bf16
# attentions' distances from the plain path agree in size, not in value
ZOO_FREE_SLACK = 1.5


# phase 15: the LM on the process grid, llama3.2-1b at its published
# widths in bf16 (seed 0).  (a) a 1 x 1 NCCL grid: serve (prefill_32k's
# 32 x 32768 cut to 4 x 4096, 32 tokens) and train (train_4k's batch 256
# cut to 4, seq 4096, --remat, 3 steps) against the single-device path
# from the same weights, and ef_psum at wq's shape; (b) a 1 x 2 grid of
# two processes on the one card (gloo on CUDA tensors: NCCL refuses two
# ranks on one GPU), tensor parallel: 2 x 2048, 16 tokens
GRID_LM = dict(arch="llama3.2-1b", layers=16, batch=4, prompt=4096,
               new_tokens=32, train_batch=4, train_seq=4096, train_steps=3,
               lr=1e-3, ef_shape=(2048, 2048))
GRID_TP = dict(model=2, batch=2, prompt=2048, new_tokens=16, heads=(16, 4))
# (a) the 1 x 1 grid runs the single-device arithmetic (no collective in
# the forward; the train step's gradients pass a group of one and its
# global norm sums the same squares in another order): logits within
# this, every greedy token equal; losses within GRID_LOSS_TOL and the
# parameters within 2 * lr per step (an AdamW step moves a parameter by
# about lr * sign(g), which a near-zero g's rounding can flip)
GRID_ONE_TOL = 1e-2
GRID_LOSS_TOL = 1e-3
# (b) tensor parallel in bf16 sums the row-parallel products' partials in
# another order: phase 8's LM_BF16_TOL, and at least this share of the
# greedy tokens equal
GRID_TP_SAME = 0.9


# phase 16: the LM zoo's other families on the process grid, bf16, seed 0.
# (a) deepseek-moe-16b on a 1 x 1 NCCL grid at phase 14 (a)'s cut; (b) a
# 1 x 2 grid of two processes on the card: granite-moe-3b-a800m (20
# experts per rank) and minicpm3-4b (20 MLA heads per rank) at phase 14
# (b)'s cut, then 2 granite-moe train steps at 2 x 1024 with --remat,
# each step's loss and grad norm against the single device's steps from
# the same state and batches: the first step's within GRID_LOSS_TOL, the
# second's within GRID_ZOO_UPDATED_TOL.  AdamW's first update moves every
# parameter with a nonzero gradient by about lr whatever the gradient's
# size, so bf16 rounding in a small gradient (tensor parallel sums in
# another order) can reverse a whole step: PERF.md §7 has the readings
# of the tree and of two planted faults that this pair tells apart
GRID_ZOO = dict(arch="deepseek-moe-16b", batch=4, prompt=4096,
                new_tokens=16)
GRID_ZOO_TP = dict(model=2, archs=("granite-moe-3b-a800m", "minicpm3-4b"),
                   batch=2, prompt=2048, new_tokens=8, train_batch=2,
                   train_seq=1024, train_steps=2, lr=1e-3)
GRID_ZOO_UPDATED_TOL = 1e-2
# phase 17: one rank's share of the exascale cells on a 1 x 1 NCCL grid
# (the 16 x 16 plan's local shapes), timed over EXA_ITERS MU iterations;
# the allocator's peak held to the 1 x 1 plan within EXA_PEAK_TOL
EXA = dict(k=10, seed=0)
EXA_ITERS = 20
EXA_PEAK_TOL = 0.10
EXA_SPMM_SLICES = 4       # (b)'s product checked this many slices at a time
# phase 18: a roofline share above this means the count missed work
ROOFLINE_MAX = 1.05
COUNT_S: list[float] = []  # phase 18's own seconds, part by part
# the LM peaks measured by phases 8, 13 and 14 in this run, against
# the dry run's plan at each phase's own cut shape on a 1 x 1 grid
MEASURED_PEAKS: dict[str, int] = {}


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# Phase 1: build and report
# ---------------------------------------------------------------------------

def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    log(f"[build] kernel library {lib.relative_to(ROOT)}: "
        f"{len(_build.sources())} sources built and loaded in "
        f"{time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def compare(name: str, got, ref, rel_tol: float = REL_TOL,
            abs_tol: float = ABS_TOL) -> float:
    """Raise unless got ~ ref (relative Frobenius error <= rel_tol, max
    |diff| <= abs_tol * max |ref|); return max |got - ref|."""
    import torch
    require(got.shape == ref.shape,
            f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got - ref).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    ref_max = float(ref.abs().max()) if ref.numel() else 0.0
    ref_norm = float(torch.linalg.vector_norm(ref))
    if ref_norm == 0.0:
        require(max_abs == 0.0, f"{name}: reference is zero, kernel is not")
        return 0.0
    rel = float(torch.linalg.vector_norm(got - ref)) / ref_norm
    require(rel <= rel_tol, f"{name}: relative error {rel:.3e} > {rel_tol}")
    require(max_abs <= abs_tol * ref_max,
            f"{name}: max |diff| {max_abs:.3e} > {abs_tol} * {ref_max:.3e}")
    return max_abs


def pattern_bcsr(rows, cols, n, bs, m, r, gen, dev):
    """A BCSR with the given (row-major) block pattern and uniform values,
    zero in the padded tail; member-stacked when r is not None."""
    import torch
    from repro_torch.core.sparse import BCSR, tail_mask
    nb = -(-n // bs)
    lead = (r, m) if r is not None else (m,)
    data = torch.rand(lead + (len(rows), bs, bs), generator=gen, device=dev)
    if rows:
        mask = tail_mask(n, bs, nb, device=dev).reshape(nb, bs)
        rt = torch.tensor(rows, device=dev)
        ct = torch.tensor(cols, device=dev)
        data *= mask[rt][:, :, None] * mask[ct][:, None, :]
    return BCSR(data=data.contiguous(),
                block_rows=torch.tensor(rows, dtype=torch.int32, device=dev),
                block_cols=torch.tensor(cols, dtype=torch.int32, device=dev),
                n=n)


def check_edges(dev) -> None:
    """Both kernels at the edge shapes, against their plain versions; XA
    bit-identical across two calls; empty block rows and cols exactly
    zero."""
    import torch
    from repro_torch.kernels import bcsr_fused, bcsr_spmm, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # nb = 5 (or 7): block rows 1 and 3 and block cols 0 and 4 store nothing
    gappy = ([0, 0, 2, 2, 4], [1, 3, 1, 2, 3])
    # nb = 47: block row 0 holds 44 blocks, rows 1-2 and 4-45 none, block
    # cols 44 and 45 none (uneven work per block row)
    uneven = ([0] * 44 + [3, 3, 46], list(range(44)) + [0, 5, 46])
    # a grid shard's front padding: 300 repeated (0, 0) blocks before the
    # real ones, block row 0 one long unit (values nonzero here, so the
    # repeats' sums are checked too)
    padded = ([0] * 300 + [0, 0, 2, 2, 4], [0] * 300 + [0, 3, 1, 2, 3])
    cases = [  # (n, bs, pattern, k, data members, operand members)
        (600, 128, gappy, 3, None, None),      # bs does not divide n
        (600, 128, gappy, 16, 4, 4),           # r = 4, k = 16
        (150, 32, gappy, 3, 4, 4),             # bs = 32, tail 10
        (160, 32, gappy, 16, None, 4),         # shared data, r = 4 operand
        (256, 128, ([], []), 3, None, None),   # nnzb == 0
        (256, 128, ([], []), 16, 4, 4),
        (6000, 128, uneven, 5, 4, 4),          # 44 blocks beside empty rows
        (6000, 128, uneven, 8, None, 4),       # the same, shared data
        (300, 64, gappy, 5, None, None),       # bs = 64
        (300, 64, gappy, 4, 4, 4),
        (450, 96, gappy, 9, 4, 4),             # bs = 96, two k-slices
        (450, 96, gappy, 8, None, 4),
        (600, 128, gappy, 1, None, 4),         # k = 1, shared data
        (600, 128, gappy, 12, 4, 4),           # k = 12: a half-full k-slice
        (600, 128, gappy, 33, 4, 4),           # k = 33: five k-slices
        (200, 32, gappy, 64, None, 4),         # k = 64, shared data
        (600, 128, padded, 5, 4, 4),           # front-padded shard
        (600, 128, padded, 8, None, 4),        # the same, shared data
    ]
    for n, bs, (rows, cols), k, dr, br in cases:
        sp = pattern_bcsr(rows, cols, n, bs, 3, dr, gen, dev)
        shape = (br, n, k) if br is not None else (n, k)
        B1 = torch.rand(shape, generator=gen, device=dev)
        B2 = torch.rand(shape, generator=gen, device=dev)
        xa, xt = bcsr_fused.bcsr_xa_xta(sp, B1, B2)
        xa2, xt2 = bcsr_fused.bcsr_xa_xta(sp, B1, B2)
        sa = bcsr_spmm.bcsr_spmm(sp, B1)
        torch.cuda.synchronize()
        ra, rt = ref.ref_bcsr_xa_xta(sp, B1, B2)
        tag = f"n={n} bs={bs} nnzb={sp.nnzb} k={k} r={dr or br or 1}"
        compare(f"bcsr_xa_xta XA [{tag}]", xa, ra)
        compare(f"bcsr_xa_xta XTB [{tag}]", xt, rt)
        compare(f"bcsr_spmm [{tag}]", sa, ra)
        require(torch.equal(xa, xa2) and torch.equal(xt, xt2),
                f"bcsr_xa_xta XA or XTB differs between two calls [{tag}]")
        nb = -(-n // bs)
        for i in range(nb):
            sl = slice(i * bs, min((i + 1) * bs, n))
            if i not in rows:
                require(not xa[..., sl, :].any() and not sa[..., sl, :].any(),
                        f"empty block-row {i} not exactly zero [{tag}]")
            if i not in cols:
                require(not xt[..., sl, :].any(),
                        f"empty block-col {i} not exactly zero [{tag}]")
        log(f"[kernels] edge case {tag}: ok")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, name, reps: int):
    """Mean device milliseconds per call of the kernels whose name holds
    ``name``, from ``torch.profiler`` over ``reps`` calls (0.0 when the
    profiler records no device time); a tuple of names gives a tuple of
    times from the one session."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    names = (name,) if isinstance(name, str) else name
    ms = tuple(sum(e.device_time_total for e in events if n in e.key)
               / 1e3 / reps for n in names)
    return ms[0] if isinstance(name, str) else ms


def bound(cost: tuple[int, int], peak: float = PEAK_FP32_FLOP_PER_S
          ) -> tuple[float, str]:
    """Least time the card could take for a kernel call whose ``cost`` is
    (flops, bytes), the kernel module's ``cost``: the bytes over HBM
    bandwidth vs the operations over ``peak`` (fp32's unless given),
    whichever is larger."""
    flops, nbytes = cost
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_pattern(n, bs, off_density, seed):
    """The sweep's block pattern: the diagonal plus a seeded share of the
    off-diagonal blocks, row-major."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nb = n // bs
    keep = rng.random((nb, nb)) < off_density
    keep |= np.eye(nb, dtype=bool)
    rows, cols = np.nonzero(keep)
    return rng, rows, cols


def bsr_yardstick(sp, B):
    """torch.sparse_bsr_tensor @ B for X_t @ B, all t: the m slices
    stacked as one (m * n_pad, n_pad) BSR matrix over the same values."""
    import torch
    m, nnzb, bs = sp.m, sp.nnzb, sp.bs
    offs = torch.arange(m, device=sp.device, dtype=torch.int32) * nnzb
    crow = torch.cat([(sp.row_ptr[:-1][None, :] + offs[:, None]).reshape(-1),
                      torch.tensor([m * nnzb], dtype=torch.int32,
                                   device=sp.device)])
    col = sp.block_cols.repeat(m)
    mat = torch.sparse_bsr_tensor(crow, col, sp.data.reshape(-1, bs, bs),
                                  size=(m * sp.n_pad, sp.n_pad),
                                  check_invariants=True)
    return lambda: mat @ B


def phase_kernels(dev) -> list[dict]:
    import numpy as np
    import torch
    from repro_torch.core.sparse import BCSR
    from repro_torch.kernels import bcsr_fused, bcsr_spmm, ref

    check_edges(dev)

    cfg = FULL
    n, m, bs, r = cfg["n"], cfg["m"], cfg["bs"], cfg["r"]
    _, rows, cols = main_pattern(n, bs, cfg["off_density"], cfg["seed"])
    nnzb = len(rows)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    idx = dict(block_rows=torch.from_numpy(rows.astype(np.int32)).to(dev),
               block_cols=torch.from_numpy(cols.astype(np.int32)).to(dev),
               n=n)
    # the MU step's operand: r perturbed members, factors (r, n, k)
    sp_r = BCSR(data=torch.rand((r, m, nnzb, bs, bs), generator=gen,
                                device=dev), **idx)
    log(f"[kernels] main-path shape: r={r} m={m} nnzb={nnzb} bs={bs} n={n} "
        f"k in {BCSR_KS} ({sp_r.data.numel() * 4 / 1e9:.2f} GB of stored "
        f"blocks)")
    by_k = {}
    for k in BCSR_KS:
        A_r = torch.rand((r, n, k), generator=gen, device=dev)
        xa, xt = bcsr_fused.bcsr_xa_xta(sp_r, A_r, A_r)
        xa2, xt2 = bcsr_fused.bcsr_xa_xta(sp_r, A_r, A_r)
        torch.cuda.synchronize()
        require(torch.equal(xa, xa2) and torch.equal(xt, xt2),
                f"bcsr_xa_xta XA or XTB differs between two calls "
                f"[main, k={k}]")
        del xa2, xt2
        ra, rt = ref.ref_bcsr_xa_xta(sp_r, A_r, A_r)
        err = max(compare(f"bcsr_xa_xta XA [main, k={k}]", xa, ra),
                  compare(f"bcsr_xa_xta XTB [main, k={k}]", xt, rt))
        del xa, xt, ra, rt
        ms = cuda_ms(lambda: bcsr_fused.bcsr_xa_xta(sp_r, A_r, A_r), reps=10)
        plain = cuda_ms(lambda: ref.ref_bcsr_xa_xta(sp_r, A_r, A_r), reps=3,
                        warmup=1)
        b_ms, by = bound(bcsr_fused.cost(sp_r, A_r, A_r))
        by_k[k] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=by)
        log(f"[kernels] bcsr_xa_xta at k={k}: kernel {ms:.3f} ms "
            f"({100 * b_ms / ms:.1f}% of the bound), plain {plain:.3f} ms, "
            f"bound {b_ms:.3f} ms ({by}), max |diff| {err:.3e}, XA and "
            f"XTB bit-identical across calls")
        del A_r
    log(f"[kernels] bcsr_xa_xta at k=8: {by_k[8]['ms']:.3f} ms (PR 16's "
        f"kernel: 8.322 ms)")
    del sp_r
    torch.cuda.empty_cache()

    # the error / regression operand: the unperturbed tensor, A (n, k), at
    # the k = 8 of earlier PRs' rows
    k = 8
    sp = BCSR(data=torch.rand((m, nnzb, bs, bs), generator=gen, device=dev),
              **idx)
    A = torch.rand((n, k), generator=gen, device=dev)
    sa = bcsr_spmm.bcsr_spmm(sp, A)
    torch.cuda.synchronize()
    rs = ref.ref_bcsr_spmm(sp, A)
    err_s = compare("bcsr_spmm [main]", sa, rs)
    # the member-error call shares the data across r operand members
    A_r = torch.rand((r, n, k), generator=gen, device=dev)
    compare("bcsr_spmm [main, shared data, r operands]",
            bcsr_spmm.bcsr_spmm(sp, A_r), ref.ref_bcsr_spmm(sp, A_r))
    s_shared_ms = cuda_ms(lambda: bcsr_spmm.bcsr_spmm(sp, A_r), reps=10)
    del sa, rs
    s_ms = cuda_ms(lambda: bcsr_spmm.bcsr_spmm(sp, A), reps=20)
    s_plain = cuda_ms(lambda: ref.ref_bcsr_spmm(sp, A), reps=5, warmup=1)
    s_bound, s_by = bound(bcsr_spmm.cost(sp, A))
    lib_fn = bsr_yardstick(sp, A)
    compare("torch.sparse_bsr_tensor @ B (yardstick)",
            lib_fn().reshape(m, n, k), bcsr_spmm.bcsr_spmm(sp, A))
    s_lib = cuda_ms(lib_fn, reps=10)
    del lib_fn
    log(f"[kernels] bcsr_spmm with shared data and r={r} operand members: "
        f"{s_shared_ms:.3f} ms (reads the stored blocks once per member)")
    del sp, A, A_r
    torch.cuda.empty_cache()

    rows_out = [
        dict(name="bcsr_xa_xta", route="cuda",
             source="src/repro_torch/kernels/csrc/bcsr_fused.cu",
             replaces="src/repro/kernels/bcsr_fused.py:123",
             launches=0, library_ms=None, **by_k[FULL["k_max"]]),
        dict(name="bcsr_spmm", route="cuda",
             source="src/repro_torch/kernels/csrc/bcsr_spmm.cu",
             replaces="src/repro/kernels/bcsr_spmm.py:89",
             launches=0, max_abs_err=err_s, ms=s_ms, plain_ms=s_plain,
             bound_ms=s_bound, bound_by=s_by, library_ms=s_lib),
    ]
    for row in rows_out:
        log(f"[kernels] {row['name']}: kernel {row['ms']:.3f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}), library {row['library_ms']}, "
            f"max |diff| {row['max_abs_err']:.3e}")
    return rows_out


def check_fused_edges(dev) -> None:
    """fused_xa_xtb against its plain version at the edge shapes."""
    import torch
    from repro_torch.kernels import fused_bilinear, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cases = [  # (m, n1, n2, k, r, B2 shared over m)
        (3, 37, 1000, 3, None, False), (3, 1000, 37, 5, 4, True),
        (2, 1, 37, 1, None, True), (2, 37, 1, 16, 4, False),
        (1, 1000, 1000, 64, None, False), (4, 1000, 1000, 5, 4, True),
        (2, 37, 37, 64, 4, True), (2, 1000, 999, 16, 1, False),
        (2, 300, 1000, 3, 4, True), (2, 1100, 2600, 10, 4, True),
        (2, 700, 333, 24, None, False),
    ]
    for m, n1, n2, k, r, shared in cases:
        lead = (r,) if r is not None else ()
        X = torch.rand(lead + (m, n1, n2), generator=gen, device=dev)
        B1 = torch.rand(lead + (n2, k), generator=gen, device=dev)
        if shared:
            B2 = torch.rand(lead + (1, n1, k), generator=gen,
                            device=dev).expand(lead + (m, n1, k))
        else:
            B2 = torch.rand(lead + (m, n1, k), generator=gen, device=dev)
        tag = f"m={m} n1={n1} n2={n2} k={k} r={r or 1} shared={shared}"
        xa, xt = fused_bilinear.fused_xa_xtb(X, B1, B2)
        xa2, xt2 = fused_bilinear.fused_xa_xtb(X, B1, B2)
        torch.cuda.synchronize()
        require(torch.equal(xa, xa2) and torch.equal(xt, xt2),
                f"fused_xa_xtb XA or XTB differs between two calls [{tag}]")
        ra, rt = ref.ref_fused_xa_xtb(X, B1, B2)
        compare(f"fused_xa_xtb XA [{tag}]", xa, ra)
        compare(f"fused_xa_xtb XTB [{tag}]", xt, rt)
        if m > 1:   # the sliced schedule's call: a slice view, m = 1
            Xt = X[..., 1:2, :, :]
            B2t = B2[..., 1:2, :, :]
            xa, xt = fused_bilinear.fused_xa_xtb(Xt, B1, B2t)
            torch.cuda.synchronize()
            ra, rt = ref.ref_fused_xa_xtb(Xt, B1, B2t)
            compare(f"fused_xa_xtb XA [slice, {tag}]", xa, ra)
            compare(f"fused_xa_xtb XTB [slice, {tag}]", xt, rt)
        log(f"[fused] edge case {tag}: ok")


def phase_fused(dev) -> dict:
    """fused_xa_xtb at the edge shapes, then held and timed on the grid
    sweep's operands: X (r, m, n, n), B1 = A (r, n, k) and B2 = A broadcast
    over the m slices (stride 0), as ``core.rescal.dense_products`` passes
    them on a 1 x 1 grid, at each k of FUSED_SCALE; beside each, the two
    cuBLAS calls X @ B1 and X^T @ B2 (strict fp32) as a yardstick of
    reading X twice (no single call computes the pair: library_ms
    stays null)."""
    import torch
    from repro_torch.kernels import fused_bilinear, ref
    check_fused_edges(dev)
    cfg = FUSED_SCALE
    r, m, n = cfg["r"], cfg["m"], cfg["n"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    X = torch.rand((r, m, n, n), generator=gen, device=dev)
    log(f"[fused] main-path shape: r={r} m={m} n={n} k in {cfg['ks']} "
        f"({X.numel() * 4 / 1e9:.2f} GB of X)")
    by_k = {}
    for k in cfg["ks"]:
        A = torch.rand((r, n, k), generator=gen, device=dev)
        B2 = A.unsqueeze(-3).expand(r, m, n, k)
        xa, xt = fused_bilinear.fused_xa_xtb(X, A, B2)
        xa2, xt2 = fused_bilinear.fused_xa_xtb(X, A, B2)
        torch.cuda.synchronize()
        require(torch.equal(xa, xa2) and torch.equal(xt, xt2),
                f"fused_xa_xtb XA or XTB differs between two calls "
                f"[main, k={k}]")
        del xa2, xt2
        ra, rt = ref.ref_fused_xa_xtb(X, A, B2)
        err = max(compare(f"fused_xa_xtb XA [main, k={k}]", xa, ra),
                  compare(f"fused_xa_xtb XTB [main, k={k}]", xt, rt))
        del xa, xt, ra, rt
        ms = cuda_ms(lambda: fused_bilinear.fused_xa_xtb(X, A, B2), reps=10)
        plain = cuda_ms(lambda: ref.ref_fused_xa_xtb(X, A, B2), reps=3,
                        warmup=1)
        pair = cuda_ms(lambda: (X @ A.unsqueeze(-3),
                                X.transpose(-1, -2) @ B2), reps=3)
        b_ms, by = bound(fused_bilinear.cost(X, A, B2))
        by_k[k] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=by)
        log(f"[fused] fused_xa_xtb at k={k}: kernel {ms:.3f} ms, plain "
            f"{plain:.3f} ms, bound {b_ms:.3f} ms ({by}, "
            f"{100 * b_ms / ms:.1f}% of it), cuBLAS pair X @ B1 + X^T @ "
            f"B2 {pair:.3f} ms, max |diff| {err:.3e}, XA and XTB "
            f"bit-identical across calls")
        if k == cfg["sliced_k"]:
            # the sliced schedule's call at full size: one slice of one member
            Xt, B2t = X[0, 2:3], B2[0, 2:3]
            got = fused_bilinear.fused_xa_xtb(Xt, A[0], B2t)
            want = ref.ref_fused_xa_xtb(Xt, A[0], B2t)
            compare(f"fused_xa_xtb XA [main, one slice, k={k}]", got[0],
                    want[0])
            compare(f"fused_xa_xtb XTB [main, one slice, k={k}]", got[1],
                    want[1])
            del got, want
            slice_ms = cuda_ms(
                lambda: fused_bilinear.fused_xa_xtb(Xt, A[0], B2t), reps=20)
            s_ms, _ = bound(fused_bilinear.cost(Xt, A[0], B2t))
            log(f"[fused] one slice (m = 1, n = {n}, k = {k}): "
                f"{slice_ms:.3f} ms, bound {s_ms:.3f} ms "
                f"({100 * s_ms / slice_ms:.1f}% of it)")
            del Xt, B2t
        del A, B2
    del X
    torch.cuda.empty_cache()
    return dict(name="fused_xa_xtb", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_bilinear.cu",
                replaces="src/repro/kernels/fused_bilinear.py:90",
                launches=0, library_ms=None, **by_k[cfg["line_k"]])


def check_mu_edges(dev) -> None:
    """mu_update_a against its plain version at the edge shapes: any n
    (empty and ragged), k from 1 to 64, one or four members, S per member
    or shared (member stride 0), and padded columns, which must stay
    exact zeros; k = 65 is refused."""
    import torch
    from repro_torch.kernels import mu_update_a as mu
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    eps = 1e-16
    for n in (0, 1, 37, 1000):
        for k in (1, 3, 5, 16, 64):
            for r, shared in ((None, False), (4, False), (4, True)):
                lead = (r,) if r is not None else ()
                A = torch.rand(lead + (n, k), generator=gen, device=dev)
                Num = torch.rand(lead + (n, k), generator=gen, device=dev)
                S = torch.rand((k, k) if shared or r is None
                               else lead + (k, k), generator=gen, device=dev)
                if shared:
                    S = S.expand(r, k, k)
                got = mu.mu_update_a(A, Num, S, eps)
                torch.cuda.synchronize()
                compare(f"mu_update_a [n={n} k={k} r={r or 1} "
                        f"shared={shared}]", got,
                        ref.ref_mu_update_a(A, Num, S, eps))
        log(f"[mu] edge cases n={n}: ok")
    # padded cells (the cross-k grid): columns past each cell's rank zero
    # in A and in S's rows and columns
    ks, k_max, n = (2, 3, 4, 5), 5, 1000
    mask = (torch.arange(k_max, device=dev)[None, :]
            < torch.tensor(ks, device=dev)[:, None]).float()
    A = torch.rand((len(ks), n, k_max), generator=gen, device=dev) \
        * mask[:, None, :]
    Num = torch.rand(A.shape, generator=gen, device=dev) * mask[:, None, :]
    S = torch.rand((len(ks), k_max, k_max), generator=gen, device=dev) \
        * (mask[:, :, None] * mask[:, None, :])
    got = mu.mu_update_a(A, Num, S, eps)
    torch.cuda.synchronize()
    compare("mu_update_a [padded cells]", got,
            ref.ref_mu_update_a(A, Num, S, eps))
    require(not (got * (1 - mask[:, None, :])).any(),
            "mu_update_a: a padded column is not exactly zero")
    try:
        mu.mu_update_a(torch.rand((4, 65), device=dev),
                       torch.rand((4, 65), device=dev),
                       torch.rand((65, 65), device=dev), eps)
    except ValueError:
        pass
    else:
        raise PhaseError("mu_update_a accepted k = 65")
    log("[mu] padded cells stay exact zeros; k = 65 refused")


def phase_mu(dev) -> dict:
    """mu_update_a at the edge shapes, then held and timed at the sweeps'
    shapes (A and Num (r, n, k), S (r, k, k)) beside its plain version and
    its bound: A and Num read and the update written once (12 bytes per
    element, S's k*k per member besides), 2k + 2 flop per element."""
    import torch
    from repro_torch.kernels import mu_update_a as mu
    from repro_torch.kernels import ref
    check_mu_edges(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    eps = 1e-16
    cases = []
    for cfg in MU_SCALES:
        r, n, k = cfg["r"], cfg["n"], cfg["k"]
        A = torch.rand((r, n, k), generator=gen, device=dev)
        Num = torch.rand((r, n, k), generator=gen, device=dev)
        S = torch.rand((r, k, k), generator=gen, device=dev)
        got = mu.mu_update_a(A, Num, S, eps)
        torch.cuda.synchronize()
        err = compare(f"mu_update_a [r={r} n={n} k={k}]", got,
                      ref.ref_mu_update_a(A, Num, S, eps))
        cases.append((cfg, (A, Num, S), err))
    # times per call for every shape first, then the profiled device times
    times = [(cuda_ms(lambda: mu.mu_update_a(*x, eps), reps=200),
              cuda_ms(lambda: ref.ref_mu_update_a(*x, eps), reps=200))
             for _, x, _ in cases]
    row = None
    for (cfg, x, err), (ms, plain) in zip(cases, times):
        r, n, k = cfg["r"], cfg["n"], cfg["k"]
        dev_ms = device_ms(lambda: mu.mu_update_a(*x, eps),
                           "mu_update_a_kernel", reps=50)
        b_ms, by = bound(mu.cost(*x))
        log(f"[mu] mu_update_a at r={r} n={n} k={k}: kernel {ms:.4f} ms "
            f"per call ({dev_ms:.4f} ms on the device per launch, "
            f"torch.profiler; {100 * b_ms / dev_ms:.1f}% of the bound), "
            f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({by}), max |diff| "
            f"{err:.3e}")
        row = dict(name="mu_update_a", route="cuda",
                   source="src/repro_torch/kernels/csrc/mu_update_a.cu",
                   replaces="src/repro/kernels/mu_ratio.py:43",
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                   bound_ms=b_ms, bound_by=by, library_ms=None)
    del cases, x
    torch.cuda.empty_cache()
    return row


def topk_check(name: str, V64, A64, s, i, ref_s) -> float:
    """Hold a score_topk result (s, i) to the plain version's scores ref_s
    and to float64 scores recomputed from V64 (b, k) and A64 (n, k).  Near
    ties may swap between two correct answers, so this checks a top-k, not
    index by index: the scores match the plain version's; each returned
    index's float64 score matches its reported score; no index left out
    scores above the last reported score; scores descend; the indices are
    distinct; slots past n are (-inf, -1).  Tolerance TOPK_TOL times the
    row's largest |score|.  Returns max |s - ref_s| over the real slots."""
    import torch
    b, topk = s.shape
    n = A64.shape[0]
    require(s.dtype == torch.float32 and i.dtype == torch.int32
            and tuple(i.shape) == (b, topk) == tuple(ref_s.shape),
            f"{name}: got {s.dtype} {tuple(s.shape)}, {i.dtype} "
            f"{tuple(i.shape)}; plain {tuple(ref_s.shape)}")
    t = min(topk, n)
    require(bool((i[:, t:] == -1).all()) and bool(torch.isneginf(
        s[:, t:]).all()), f"{name}: slots past n are not (-inf, -1)")
    S, I = s[:, :t].double(), i[:, :t].long()
    require(bool(((I >= 0) & (I < n)).all()), f"{name}: index out of range")
    require(bool((S[:, :-1] >= S[:, 1:]).all()), f"{name}: not descending")
    srt = torch.sort(I, dim=1).values
    require(bool((srt[:, 1:] > srt[:, :-1]).all()),
            f"{name}: repeated index")
    worst = 0.0
    for r0 in range(0, b, 16):                 # (16, n) float64 at a time
        rows = slice(r0, min(b, r0 + 16))
        full = V64[rows] @ A64.T
        tol = TOPK_TOL * full.abs().amax(dim=1)
        diff = (S[rows] - ref_s[rows, :t].double()).abs()
        worst = max(worst, float(diff.max()))
        require(bool((diff <= tol[:, None]).all()),
                f"{name}: scores differ from the plain version's by "
                f"{float(diff.max()):.3e}")
        exact = full.gather(1, I[rows])
        require(bool(((exact - S[rows]).abs() <= tol[:, None]).all()),
                f"{name}: a reported score differs from its float64 value")
        left = full.scatter(1, I[rows], -torch.inf).amax(dim=1)
        require(bool((left <= S[rows, -1] + tol).all()),
                f"{name}: an index left out scores above the last "
                f"reported score")
    return worst


def time_topk(V, A, topk: int, reps: int, plain_reps: int) -> dict:
    """score_topk kernel, plain version and yardstick times on (V, A), with
    the bound from this call's bytes and operations and the device time of
    each of the kernel's two launches (stage 1 and stage 2)."""
    import torch
    from repro_torch.kernels import ref, score_topk
    b, k = V.shape
    n = A.shape[0]

    def run():
        return score_topk.score_topk(V, A, topk=topk)

    ms = cuda_ms(run, reps=reps)
    stage1, stage2 = device_ms(run, ("stopk::chunk_kernel",
                                     "stopk::merge_kernel"), reps=20)
    plain = cuda_ms(lambda: ref.ref_score_topk_stream(V, A, topk),
                    reps=plain_reps, warmup=1)
    lib = cuda_ms(lambda: torch.topk(V @ A.T, topk, dim=1), reps=reps)
    bound_ms, by = bound(score_topk.cost(V, A, topk))
    busy = stage1 + stage2
    log(f"[score_topk] b={b} n={n} k={k} topk={topk}: kernel {ms:.4f} ms "
        f"per call ({stage1:.4f} + {stage2:.4f} = {busy:.4f} ms on the "
        f"device, stage 1 + stage 2, torch.profiler), plain {plain:.4f} "
        f"ms, torch.topk(V @ A.T) {lib:.4f} ms, bound {bound_ms:.4f} ms "
        f"({by}; {100 * bound_ms / ms:.1f}% of it per call, "
        f"{100 * bound_ms / busy if busy else 0.0:.1f}% on the device)")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                bound_by=by)


def phase_topk(dev) -> dict:
    """score_topk against its plain version at edge shapes and an
    exact-tie case, and timed at the serving-scale shape."""
    import torch
    from repro_torch.kernels import ref, score_topk
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cases = [(n, topk) for n, topk in ((1, 1), (1, 10), (5, 10), (1000, 1),
                                       (1000, 10), (1000, 32), (1000, 33),
                                       (1000, 100))]
    for b in (1, 32, 128):
        for k in (3, 32):
            for n, topk in cases + ([(3000, 257), (3000, 1024)] if b == 32
                                    else []):
                V = torch.rand((b, k), generator=gen, device=dev)
                A = torch.rand((n, k), generator=gen, device=dev)
                s, i = score_topk.score_topk(V, A, topk=topk)
                torch.cuda.synchronize()
                rs, _ = ref.ref_score_topk_stream(V, A, topk)
                topk_check(f"score_topk [b={b} n={n} k={k} topk={topk}]",
                           V.double(), A.double(), s, i, rs)
            log(f"[score_topk] edge cases b={b} k={k}: ok")
    # exact ties: small integers sum exactly in any order, and the rows of
    # A repeat every 250 rows.  At n = 500 each chunk is one tile; at
    # n = 40000 chunks hold several, so ties are also broken between a
    # full running list and a later tile's candidates
    sms = score_topk.sm_count(dev)
    base = torch.randint(0, 3, (250, 8), generator=gen, device=dev)
    for b, n in ((32, 500), (32, 40000), (128, 40000)):
        A = base[torch.arange(n, device=dev) % 250].float().contiguous()
        V = torch.randint(0, 3, (b, 8), generator=gen, device=dev).float()
        p = score_topk.plan(b, n, 8, 100, sms)
        require(n == 500 or p.chunk_rows > 256,
                f"score_topk: the tie case b={b} n={n} has one-tile chunks")
        for topk in (1, 10, 32, 33, 100):
            s, i = score_topk.score_topk(V, A, topk=topk)
            rs, ri = ref.ref_score_topk_stream(V, A, topk)
            require(torch.equal(s, rs) and torch.equal(i, ri),
                    f"score_topk: exact-tie case b={b} n={n} topk={topk} "
                    f"differs from the plain version")
        log(f"[score_topk] exact-tie case b={b} n={n} ({p.n_chunks} chunks "
            f"of {p.chunk_rows} rows): scores and indices equal the plain "
            f"version's")

    cfg = TOPK_SCALE
    V = torch.rand((cfg["b"], cfg["k"]), generator=gen, device=dev)
    A = torch.rand((cfg["n"], cfg["k"]), generator=gen, device=dev)
    s, i = score_topk.score_topk(V, A, topk=cfg["topk"])
    torch.cuda.synchronize()
    rs, _ = ref.ref_score_topk_stream(V, A, cfg["topk"])
    err = topk_check("score_topk [serving scale]", V.double(), A.double(),
                     s, i, rs)
    log(f"[score_topk] serving scale: max |diff| {err:.3e}")
    time_topk(V, A, cfg["topk"], reps=10, plain_reps=2)
    del V, A, s, i, rs
    torch.cuda.empty_cache()
    cfg = TOPK_SERVE
    V = torch.rand((cfg["b"], cfg["k"]), generator=gen, device=dev)
    A = torch.rand((cfg["n"], cfg["k"]), generator=gen, device=dev)
    time_topk(V, A, cfg["topk"], reps=50, plain_reps=5)
    return dict(name="score_topk", route="cuda",
                source="src/repro_torch/kernels/csrc/score_topk.cu",
                replaces="src/repro/kernels/score_topk.py:112",
                launches=0, max_abs_err=None, ms=None, plain_ms=None,
                bound_ms=None, bound_by=None, library_ms=None)


# ---------------------------------------------------------------------------
# Phases 3 and 4: the sweep through the CLI
# ---------------------------------------------------------------------------

def write_planted_npz(path: Path, cfg: dict) -> int:
    """A seeded planted COO file at the sweep's size: values A R A^T (rank
    4, community-structured A) at ~fill of each stored block's entries."""
    import numpy as np
    n, m, bs = cfg["n"], cfg["m"], cfg["bs"]
    rng, brows, bcols = main_pattern(n, bs, cfg["off_density"], cfg["seed"])
    per = int(round(cfg["fill"] * bs * bs))
    nnzb = len(brows)
    k_true = 4
    A = 0.05 + 0.1 * rng.random((n, k_true), dtype=np.float32)
    A[np.arange(n), rng.integers(0, k_true, n)] += 1.0
    R = rng.uniform(0.05, 0.5, (m, k_true, k_true)).astype(np.float32)
    R[:, np.arange(k_true), np.arange(k_true)] += 1.0
    pos = rng.integers(0, bs * bs, (m, nnzb, per), dtype=np.int64)
    rel = np.broadcast_to(np.arange(m)[:, None, None], pos.shape).ravel()
    row = (brows[None, :, None] * bs + pos // bs).ravel()
    col = (bcols[None, :, None] * bs + pos % bs).ravel()
    val = np.empty(row.shape[0], np.float32)
    step = 1 << 22
    for s in range(0, row.shape[0], step):
        e = s + step
        val[s:e] = np.einsum("ea,eab,eb->e", A[row[s:e]], R[rel[s:e]],
                             A[col[s:e]])
    np.savez(path, row=row, rel=rel, col=col, val=val)
    return row.shape[0]


def ms_per_iteration(rep, iters: int) -> float:
    """Ensemble unit seconds per MU iteration (all r members at once)."""
    return 1e3 * rep.total_seconds / (len(rep.units) * iters)


def run_sweep(npz: Path, report: Path, impl: str, cfg: dict, *extra: str):
    from repro_torch.launch import rescalk_run
    argv = ["--data", str(npz), "--bs", str(cfg["bs"]),
            "--k-min", str(cfg["k_min"]), "--k-max", str(cfg["k_max"]),
            "--r", str(cfg["r"]), "--iters", str(cfg["iters"]),
            "--report", str(report), "--use-fused-kernel",
            "--fused-impl", impl, *extra]
    log(f"[sweep] rescalk_run {' '.join(argv)}")
    t0 = time.perf_counter()
    res, rep = rescalk_run.main(argv)
    units = " ".join(f"k={u.k}:{u.seconds:.3f}s" for u in rep.units)
    ms = ms_per_iteration(rep, cfg["iters"])
    require(rep.meta["n_kernel_fallbacks"] == 0,
            f"the sweep fell back to a plain version: {rep.meta}")
    if impl == "auto" and not extra:
        MS_PER_ITER.setdefault("phase 3", ms)
    log(f"[sweep] impl={impl}: {time.perf_counter() - t0:.1f}s wall; "
        f"ensemble units {units}; per MU iteration {ms:.2f} ms")
    return res, rep


def check_sweep(res, report: Path, cfg: dict) -> None:
    import numpy as np
    require(report.exists(), f"report {report} not written")
    saved = json.loads(report.read_text())
    require(saved["k_opt"] == res.k_opt, "report k_opt differs")
    require(list(res.ks) == list(range(cfg["k_min"], cfg["k_max"] + 1)),
            f"unexpected ks {list(res.ks)}")
    for name in ("s_min", "s_mean", "rel_err"):
        require(bool(np.isfinite(getattr(res, name)).all()),
                f"non-finite {name}: {getattr(res, name)}")
    for k, kr in res.per_k.items():
        require(kr.A_median.shape == (cfg["n"], k), f"A_median shape, k={k}")
        require(bool(np.isfinite(kr.A_median).all())
                and bool((kr.A_median >= 0).all()), f"A_median, k={k}")
        require(bool(np.isfinite(kr.R_regress).all())
                and bool((kr.R_regress >= 0).all()), f"R_regress, k={k}")
        require(bool(np.isfinite(kr.member_errors).all()),
                f"member errors, k={k}")


def phase_sweeps(kernel_rows: list[dict], tmp: Path):
    """Phases 3 and 4; returns the bundle the kernel sweep wrote, and
    that sweep's result and report."""
    import numpy as np
    from repro_torch.kernels import ops
    cfg = FULL
    sweep_kernels = ("bcsr_xa_xta", "bcsr_spmm")
    npz = tmp / "planted.npz"
    t0 = time.perf_counter()
    nnz = write_planted_npz(npz, cfg)
    log(f"[sweep] wrote {nnz} triples in {time.perf_counter() - t0:.1f}s")

    ops.reset_launch_counts()
    res, rep = run_sweep(npz, tmp / "cuda.json", "auto", cfg)
    launches = ops.launch_counts()
    log(f"[sweep] kernel launches in the main path: {launches}")
    for name in sweep_kernels:
        require(launches[name] > 0, f"{name} was not launched in the sweep")
    want = (cfg["k_max"] - cfg["k_min"] + 1) * cfg["iters"]
    require(launches["mu_update_a"] == want,
            f"mu_update_a launched {launches['mu_update_a']} times, want "
            f"{want} (one per MU iteration)")
    check_sweep(res, tmp / "cuda.json", cfg)
    for row in kernel_rows:
        if row["name"] in sweep_kernels:
            row["launches"] = launches[row["name"]]
    bundle = tmp / "cuda.bundle"
    require(json.loads((tmp / "cuda.json").read_text())["meta"].get(
        "bundle") == str(bundle), "the report does not point at its bundle")

    ops.reset_launch_counts()
    ref, _ = run_sweep(npz, tmp / "ref.json", "ref", cfg)
    require(not any(ops.launch_counts().values()),
            "the ref sweep launched a kernel")
    check_sweep(ref, tmp / "ref.json", cfg)

    require(res.k_opt == ref.k_opt,
            f"k_opt differs: kernels {res.k_opt}, ref {ref.k_opt}")
    for name in ("s_min", "s_mean", "rel_err"):
        a, b = getattr(res, name), getattr(ref, name)
        worst = float(np.abs(a - b).max())
        log(f"[sweep] {name}: kernels {np.round(a, 6).tolist()} ref "
            f"{np.round(b, 6).tolist()} max |diff| {worst:.2e}")
        require(worst <= SWEEP_TOL, f"{name} differs by {worst:.2e}")
    log(f"[sweep] k_opt = {res.k_opt} on both paths")
    return bundle, res, rep


# ---------------------------------------------------------------------------
# Phase 5: serve the sweep's bundle through the CLI
# ---------------------------------------------------------------------------

def run_serve(bundle: Path, impl: str, *extra: str):
    import numpy as np
    from repro_torch.launch import serve
    cfg = SERVE
    argv = ["--factors", str(bundle), "--queries", cfg["queries"],
            "--batch", str(cfg["batch"]), "--topk", str(cfg["topk"]),
            "--requests", str(cfg["requests"]), "--mode", cfg["mode"],
            "--seed", str(cfg["seed"]), "--impl", impl, *extra]
    log(f"[serve] serve {' '.join(argv)}")
    out = serve.main(argv)
    lat = out.latencies
    log(f"[serve] impl={impl}: {len(out.results)} queries, p50 "
        f"{float(np.percentile(lat, 50)) * 1e3:.3f} ms, p99 "
        f"{float(np.percentile(lat, 99)) * 1e3:.3f} ms, "
        f"{len(out.results) / out.seconds:.1f} q/s, stats {out.stats}")
    # the first request pays the engine's one-time set-up; apart from it,
    # the p99 of 16 requests is their maximum
    log(f"[serve] impl={impl}: first request (cold) {lat[0] * 1e3:.3f} ms; "
        f"requests 2-{len(lat)}: p50 "
        f"{float(np.percentile(lat[1:], 50)) * 1e3:.3f} ms, max "
        f"{float(lat[1:].max()) * 1e3:.3f} ms")
    return out


def query_vectors(A, R, queries):
    """V (b, k) of queries, as the engine forms them: A[anchor] @ R[rel]
    for (s, r, ?), A[anchor] @ R[rel]^T for (?, r, o), in A's dtype."""
    import torch
    dev = A.device
    Rq = R[torch.tensor([q.rel for q in queries], device=dev)]
    sro = torch.tensor([q.mode == "sro" for q in queries], device=dev)
    Rq = torch.where(sro[:, None, None], Rq, Rq.transpose(1, 2))
    anchors = torch.tensor([q.anchor for q in queries], device=dev)
    return torch.einsum("bi,bij->bj", A[anchors], Rq).contiguous()


def phase_serve(bundle: Path, row: dict, dev):
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref, score_topk
    from repro_torch.serve import FactorBundle, random_queries
    ops.reset_launch_counts()
    got = run_serve(bundle, "auto")
    launches = ops.launch_counts()["score_topk"]
    log(f"[serve] score_topk launches in the serve path: {launches}")
    require(launches == got.stats["batches"] > 0,
            f"score_topk launched {launches} times for "
            f"{got.stats['batches']} device batches")
    row["launches"] = launches
    ops.reset_launch_counts()
    plain = run_serve(bundle, "ref")
    require(not any(ops.launch_counts().values()),
            "the ref serve run launched a kernel")
    require(got.stats == plain.stats,
            f"stats differ: {got.stats} vs {plain.stats}")

    # every answer of both runs, against float64 scores
    fb = FactorBundle.load(str(bundle))
    cfg = SERVE
    count, skew = (float(x) for x in cfg["queries"].split(":")[1:])
    queries = random_queries(fb.n, fb.m, int(count), skew=skew,
                             seed=cfg["seed"], mode=cfg["mode"])
    A64 = torch.from_numpy(fb.A).double().to(dev)
    V64 = query_vectors(A64, torch.from_numpy(fb.R).double().to(dev),
                        queries)

    def stack(out, attr):
        return torch.from_numpy(np.stack([getattr(r, attr)
                                          for r in out.results])).to(dev)

    for out, name in ((got, "kernel"), (plain, "plain")):
        require(not any(r.shed for r in out.results), f"{name}: shed")
        topk_check(f"serve answers [{name}]", V64, A64, stack(out, "scores"),
                   stack(out, "indices"), stack(plain, "scores"))
    log(f"[serve] {len(queries)} answers of both runs pass the top-k check")

    # the kernel at the serve path's own shape: the bundle's A, and V of
    # the stream's first batch of distinct queries
    A = torch.from_numpy(fb.A).to(dev)
    V = query_vectors(A, torch.from_numpy(fb.R).to(dev),
                      list(dict.fromkeys(queries))[:cfg["batch"]])
    s, i = score_topk.score_topk(V, A, topk=cfg["topk"])
    torch.cuda.synchronize()
    rs, _ = ref.ref_score_topk_stream(V, A, cfg["topk"])
    row["max_abs_err"] = topk_check("score_topk [serve shape]", V.double(),
                                    A.double(), s, i, rs)
    row.update(time_topk(V, A, cfg["topk"], reps=50, plain_reps=5))
    profile_serve(fb, queries)
    return got


def profiled(fn, host: bool = True):
    """Run ``fn`` under torch.profiler, ending in a synchronize: (wall
    seconds, device busy seconds, device events by descending time).
    ``host=False`` records the device's activity alone: a window of tens
    of thousands of host ops takes minutes to summarize."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda_type = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and (getattr(e, "device_type", None) == cuda_type
                   or e.cpu_time_total == 0)]
    busy = sum(e.device_time_total for e in events) / 1e6
    return wall, busy, sorted(events, key=lambda e: -e.device_time_total)


def profile_serve(fb, queries) -> None:
    """The serve stream once more, on a fresh engine, under
    torch.profiler: wall time, the device's busy time and idle share, and
    device time by kernel, per device batch."""
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = SERVE
    engine = ServeEngine(fb, ServeConfig(topk=cfg["topk"],
                                         batch=cfg["batch"]))
    per = -(-len(queries) // cfg["requests"])

    def stream():
        for c0 in range(0, len(queries), per):
            engine.query(queries[c0:c0 + per])

    wall, busy, events = profiled(stream)
    batches = engine.stats()["batches"]
    log(f"[serve] profiled stream: {batches} device batches, wall "
        f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
        f"({100 * (1 - busy / wall):.1f}% idle); per batch "
        f"{wall / batches * 1e3:.4f} ms wall, "
        f"{busy / batches * 1e3:.4f} ms device")
    for e in events[:8]:
        log(f"[serve]   {e.device_time_total / 1e3 / batches:8.4f} ms/batch "
            f"{100 * e.device_time_total / 1e6 / busy:5.1f}%  "
            f"x{e.count:<4d} {e.key[:70]}")


# ---------------------------------------------------------------------------
# Phase 6: the dense grid sweep on a 1 x 1 NCCL grid
# ---------------------------------------------------------------------------

def run_grid_sweep(grid, X, impl: str, report: Path):
    from repro_torch.core.rescalk import rescalk
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.selection import RescalkConfig
    cfg = GRID
    rc = RescalkConfig(k_min=cfg["k_min"], k_max=cfg["k_max"],
                       n_perturbations=cfg["r"], rescal_iters=cfg["iters"],
                       regress_iters=cfg["regress_iters"], seed=cfg["seed"],
                       schedule="batched",
                       kernel=KernelPolicy(use_fused=True, impl=impl))
    t0 = time.perf_counter()
    res = rescalk(X, rc, grid=grid, report_path=str(report))
    wall = time.perf_counter() - t0
    units = json.loads(report.read_text())["units"]
    unit_s = sum(u["seconds"] for u in units)
    ms = 1e3 * unit_s / (len(units) * cfg["iters"])
    require(json.loads(report.read_text())["meta"]["n_kernel_fallbacks"]
            == 0, "the grid sweep fell back to a plain version")
    if impl == "auto":
        MS_PER_ITER["phase 6"] = ms
    log(f"[grid] impl={impl}: sweep {wall:.1f}s wall; ensemble units "
        + " ".join(f"k={u['k']}:{u['seconds']:.3f}s" for u in units)
        + f"; per MU iteration {ms:.2f} ms")
    return res


def check_grid_result(res, n, cfg=GRID) -> None:
    import numpy as np
    require(list(res.ks) == list(range(cfg["k_min"], cfg["k_max"] + 1)),
            f"unexpected ks {list(res.ks)}")
    for name in ("s_min", "s_mean", "rel_err"):
        require(bool(np.isfinite(getattr(res, name)).all()),
                f"non-finite {name}: {getattr(res, name)}")
    for k, kr in res.per_k.items():
        require(kr.A_median.shape == (n, k) and bool(
            np.isfinite(kr.A_median).all()) and bool(
            (kr.A_median >= 0).all()), f"A_median, k={k}")
        require(bool(np.isfinite(kr.R_regress).all())
                and bool((kr.R_regress >= 0).all()), f"R_regress, k={k}")


def phase_grid(row: dict, tmp: Path, dev):
    """Phase 6 (see the module docstring); sets row's launches and
    returns the kernel sweep's result."""
    import numpy as np
    import torch
    import torch.distributed
    from repro_torch.data.synthetic import synthetic_rescal
    from repro_torch.dist.engine import DistRescalConfig, dist_rescal
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch.mesh import make_grid
    cfg = GRID
    n, m = cfg["n"], cfg["m"]
    torch.cuda.empty_cache()
    grid = make_grid(data=1, model=1, device=dev)
    try:
        t0 = time.perf_counter()
        X, _, _ = synthetic_rescal(n, m, cfg["k_true"], seed=cfg["seed"],
                                   noise=cfg["noise"], device=dev)
        torch.cuda.synchronize()
        log(f"[grid] 1 x 1 grid on {torch.distributed.get_backend()}; "
            f"synthetic X (m={m}, n={n}, planted "
            f"k={cfg['k_true']}): {X.numel() * 4 / 1e9:.2f} GB in "
            f"{time.perf_counter() - t0:.2f}s")
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        c0 = grid.collectives
        res = run_grid_sweep(grid, X, "auto", tmp / "grid_cuda.json")
        launches = ops.launch_counts()
        collectives = grid.collectives - c0
        peak = torch.cuda.max_memory_allocated(dev)
        want = (cfg["k_max"] - cfg["k_min"] + 1) * cfg["iters"]
        log(f"[grid] kernel launches in the main path: {launches}; "
            f"collectives {collectives}; peak device memory "
            f"{peak / 1e9:.2f} GB")
        for name in ("fused_xa_xtb", "mu_update_a"):
            require(launches[name] == want,
                    f"{name} launched {launches[name]} times, want {want} "
                    f"(one per MU iteration)")
        require(collectives > 0, "the grid issued no collective")
        row["launches"] = launches["fused_xa_xtb"]
        check_grid_result(res, n)

        ops.reset_launch_counts()
        ref = run_grid_sweep(grid, X, "ref", tmp / "grid_ref.json")
        require(not any(ops.launch_counts().values()),
                "the ref grid sweep launched a kernel")
        check_grid_result(ref, n)
        require(res.k_opt == ref.k_opt,
                f"k_opt differs: kernel {res.k_opt}, ref {ref.k_opt}")
        for name in ("s_min", "s_mean", "rel_err"):
            a, b = getattr(res, name), getattr(ref, name)
            worst = float(np.abs(a - b).max())
            log(f"[grid] {name}: kernel {np.round(a, 6).tolist()} ref "
                f"{np.round(b, 6).tolist()} max |diff| {worst:.2e}")
            require(worst <= SWEEP_TOL, f"{name} differs by {worst:.2e}")
        log(f"[grid] k_opt = {res.k_opt} on both paths (planted "
            f"{cfg['k_true']}: {'equal' if res.k_opt == cfg['k_true'] else 'differs'})")

        # the sliced schedule: m launches per iteration
        out = {}
        for impl in ("auto", "ref"):
            gen = torch.Generator(device=dev)
            gen.manual_seed(cfg["seed"])
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            st, err = dist_rescal(
                X, cfg["sliced_k"], grid, generator=gen,
                iters=cfg["sliced_iters"],
                cfg=DistRescalConfig(schedule="sliced", kernel=KernelPolicy(
                    use_fused=True, impl=impl)))
            torch.cuda.synchronize()
            out[impl] = st
            log(f"[grid] dist_rescal sliced impl={impl}: "
                f"{cfg['sliced_iters']} iterations in "
                f"{time.perf_counter() - t0:.2f}s, rel_err {float(err):.6f}, "
                f"launches {ops.launch_counts()['fused_xa_xtb']}")
            if impl == "auto":
                require(ops.launch_counts()["fused_xa_xtb"]
                        == m * cfg["sliced_iters"],
                        "the sliced schedule did not launch m times per "
                        "iteration")
        for name in ("A", "R"):
            a, b = getattr(out["auto"], name), getattr(out["ref"], name)
            rel = float((a - b).abs().max() / b.abs().max())
            log(f"[grid] dist_rescal sliced {name}: max |diff| / max |ref| "
                f"{rel:.2e}")
            require(bool(torch.isfinite(a).all()) and rel <= SWEEP_TOL,
                    f"dist_rescal sliced {name} differs by {rel:.2e}")
        del X
    finally:
        grid.destroy()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 7: the CLI's default path, the dense sweep on one device
# ---------------------------------------------------------------------------

def run_dense_cli(tmp: Path, name: str, n: int, *extra: str):
    """One sweep through ``rescalk_run.main`` on the synthetic tensor
    (no --data); returns (result, report, launches of this run)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import rescalk_run
    cfg = DENSE
    argv = ["--n", str(n), "--m", str(cfg["m"]),
            "--k-true", str(cfg["k_true"]), "--k-min", str(cfg["k_min"]),
            "--k-max", str(cfg["k_max"]), "--r", str(cfg["r"]),
            "--iters", str(cfg["iters"]), "--use-fused-kernel",
            "--report", str(tmp / f"{name}.json"), *extra]
    log(f"[dense] rescalk_run {' '.join(argv)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, rep = rescalk_run.main(argv)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    iters = sum(len(u.cells) if u.cells else len(u.members)
                for u in rep.units) * cfg["iters"] // cfg["r"]
    require(rep.meta["n_kernel_fallbacks"] == 0,
            f"{name} fell back to a plain version: {rep.meta}")
    key = {"dense": "phase 7", "dense_grid": "phase 7 grid mode"}.get(name)
    if key is not None:
        MS_PER_ITER[key] = 1e3 * rep.total_seconds / iters
    log(f"[dense] {name}: {wall:.1f}s wall, units "
        + " ".join(f"{u.uid}:{u.seconds:.3f}s" for u in rep.units)
        + f"; {1e3 * rep.total_seconds / iters:.2f} ms per MU iteration of "
        f"{cfg['r']} members; launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_grid_result(res, n, DENSE)
    require(rep.mode == (extra[extra.index("--mode") + 1]
                         if "--mode" in extra else "batched"),
            f"{name}: the report's mode is {rep.mode}")
    torch.cuda.empty_cache()
    return res, rep, launches


def same_curves(tag: str, a, b, tol: float = SWEEP_TOL) -> None:
    """The same k_opt and per-k s_min / s_mean / rel_err within tol."""
    import numpy as np
    require(a.k_opt == b.k_opt, f"{tag}: k_opt {a.k_opt} vs {b.k_opt}")
    for name in ("s_min", "s_mean", "rel_err"):
        x, y = getattr(a, name), getattr(b, name)
        worst = float(np.abs(x - y).max())
        log(f"[dense] {tag} {name}: {np.round(x, 6).tolist()} vs "
            f"{np.round(y, 6).tolist()} max |diff| {worst:.2e}")
        require(worst <= tol, f"{tag}: {name} differs by {worst:.2e}")


def phase_dense(rows: dict, grid_res, tmp: Path) -> None:
    """Phase 7 (see the module docstring); sets the launches of
    fused_xa_xtb and mu_update_a from the full-width kernel run."""
    cfg = DENSE
    n, want = cfg["n"], (cfg["k_max"] - cfg["k_min"] + 1) * cfg["iters"]
    res, _, launches = run_dense_cli(tmp, "dense", n)
    for name in ("fused_xa_xtb", "mu_update_a"):
        require(launches[name] == want,
                f"{name} launched {launches[name]} times in the dense "
                f"sweep, want {want} (one per MU iteration)")
        rows[name]["launches"] = launches[name]
    require(res.k_opt == cfg["k_true"],
            f"the dense sweep picked k_opt = {res.k_opt}, planted "
            f"{cfg['k_true']}")
    same_curves("dense vs the 1 x 1 grid sweep (phase 6)", res, grid_res)

    ref, _, launches = run_dense_cli(tmp, "dense_ref", n, "--fused-impl",
                                     "ref")
    require(not any(launches.values()), "the ref sweep launched a kernel")
    same_curves("dense kernel vs ref", res, ref)

    chunked, rep, launches = run_dense_cli(
        tmp, "dense_grid", n, "--mode", "grid", "--grid-chunk",
        str(cfg["grid_chunk"]))
    cells = (cfg["k_max"] - cfg["k_min"] + 1) * cfg["r"]
    require(len(rep.units) == -(-cells // cfg["grid_chunk"]),
            f"grid mode ran {len(rep.units)} chunks")
    for name in ("fused_xa_xtb", "mu_update_a"):
        require(launches[name] == len(rep.units) * cfg["iters"],
                f"{name} launched {launches[name]} times in grid mode")
    same_curves("dense batched vs grid mode", res, chunked)

    small = cfg["small_n"]
    base, _, _ = run_dense_cli(tmp, "small", small)
    for name, extra in (("small_loop", ("--mode", "loop")),
                        ("small_sliced", ("--schedule", "sliced")),
                        ("small_nndsvd", ("--init", "nndsvd"))):
        other, _, launches = run_dense_cli(tmp, name, small, *extra)
        require(launches["mu_update_a"] > 0 and launches["fused_xa_xtb"] > 0,
                f"{name}: the kernels were not launched")
        require(other.k_opt == base.k_opt,
                f"{name}: k_opt {other.k_opt}, batched {base.k_opt}")
        log(f"[dense] {name}: k_opt = {other.k_opt}, as the batched run at "
            f"n = {small}")


# ---------------------------------------------------------------------------
# Phase 8: LM serving, the dense decoder through flash_attention
# ---------------------------------------------------------------------------

def flash_inputs(gen, dev, dtype, b, sq, skv, hq, hkv, d):
    """q, k, v as (b, h, s, d) views of (b, s, h, d) tensors, the model's
    layout."""
    import torch
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
               .to(dtype).transpose(1, 2)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    return q, k, v


def check_flash(name: str, got, q, k, v, **kw) -> tuple[float, float]:
    """Hold a flash_attention result to the plain version on the same
    inputs: fp32 to REL_TOL / ABS_TOL; bf16 to BF16_REL_TOL /
    BF16_ABS_TOL against the plain version in bf16 and against it on the
    fp32 copies.  Returns (relative error, max |diff|) against the plain
    version."""
    import torch
    from repro_torch.kernels import ref
    want = ref.ref_attention(q, k, v, **kw)
    require(got.dtype == q.dtype and got.shape == q.shape,
            f"{name}: {got.dtype} {tuple(got.shape)}")
    if q.dtype == torch.float32:
        err = compare(name, got, want)
    else:
        err = compare(name + " vs plain bf16", got.float(), want.float(),
                      BF16_REL_TOL, BF16_ABS_TOL)
        want32 = ref.ref_attention(q.float(), k.float(), v.float(), **kw)
        compare(name + " vs plain fp32", got.float(), want32, BF16_REL_TOL,
                BF16_ABS_TOL)
        want = want32
    return rel_frob(got, want), err


def check_flash_grid(dev) -> None:
    """flash_attention against its plain version over FLASH_CHECK: every
    dtype, head dim, (hq, hkv), causal or not, q_offset and (sq, skv)."""
    import itertools
    import torch
    from repro_torch.kernels import flash_attention as fa
    cfg = FLASH_CHECK
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    for dtype, d in itertools.product(cfg["dtypes"], cfg["dims"]):
        t0 = time.perf_counter()
        worst, worst_abs, n = 0.0, 0.0, 0
        fa.reset_launch_count()
        for (hq, hkv), causal, q_offset, sq, skv in itertools.product(
                cfg["heads"], (True, False), cfg["q_offsets"], cfg["sq"],
                cfg["skv"]):
            q, k, v = flash_inputs(gen, dev, getattr(torch, dtype),
                                   cfg["b"], sq, skv, hq, hkv, d)
            kw = dict(causal=causal, q_offset=q_offset)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            rel, err = check_flash(
                f"flash_attention [{dtype} d={d} hq={hq} hkv={hkv} "
                f"causal={causal} q_offset={q_offset} sq={sq} skv={skv}]",
                got, q, k, v, **kw)
            worst, worst_abs, n = max(worst, rel), max(worst_abs, err), n + 1
        variant = fa.VARIANTS[getattr(torch, dtype)]
        by_variant = fa.launch_count_by_variant()
        require(by_variant[variant] == n == fa.launch_count(),
                f"flash_attention {dtype} d={d}: launches {by_variant}, want "
                f"{n} of {variant}")
        log(f"[flash] {dtype} d={d} ({variant}): {n} cases ok, largest "
            f"relative error "
            f"{worst:.3e}, largest max |diff| {worst_abs:.3e} "
            f"({time.perf_counter() - t0:.1f}s)")


def sdpa_call(q, k, v, causal: bool = True, scale: float | None = None):
    """torch's scaled_dot_product_attention, GQA, on the same (b, h, s,
    d) tensors: the yardstick, timed here and never called by the
    port."""
    import torch
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=scale, enable_gqa=True)


def time_flash(dev, cfg: dict, reps: int, plain_reps: int) -> dict:
    """flash_attention at one timing shape (bf16, causal): checked against
    the plain version, then the kernel, the plain version and the
    yardstick timed with CUDA events, beside the bound from this shape's
    operations (4 b hq d times the s (s + 1) / 2 visible pairs, over the
    bf16 tensor-core peak) and bytes (q, k and v read once, the output
    written once, over the HBM rate)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, hq, hkv, s, d = (cfg[x] for x in ("b", "hq", "hkv", "s", "d"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(s)
    q, k, v = flash_inputs(gen, dev, torch.bfloat16, b, s, s, hq, hkv, d)
    tag = f"b={b} hq={hq} hkv={hkv} s={s} d={d} bf16 causal"
    fa.reset_launch_count()
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    require(fa.launch_count_by_variant()["sm90_bf16"] == 1,
            f"flash_attention [{tag}]: not the tensor-core kernel "
            f"({fa.launch_count_by_variant()})")
    rel, err = check_flash(f"flash_attention [{tag}]", got, q, k, v,
                           causal=True)
    lib_fn = sdpa_call(q, k, v)
    compare(f"scaled_dot_product_attention [{tag}] (yardstick)",
            lib_fn().float(), got.float(), BF16_REL_TOL, BF16_ABS_TOL)
    del got
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), reps=reps)
    plain = cuda_ms(lambda: ref.ref_attention(q, k, v, causal=True),
                    reps=plain_reps, warmup=1)
    lib = cuda_ms(lib_fn, reps=reps)
    cost = fa.cost(q, k, v, causal=True)
    flops = cost[0]
    bound_ms, by = bound(cost, PEAK_BF16_FLOP_PER_S)
    log(f"[flash] {tag}: kernel sm90_bf16 {ms:.3f} ms ({flops / ms / 1e9:.1f}"
        f" TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound), plain "
        f"{plain:.3f} ms, scaled_dot_product_attention {lib:.3f} ms "
        f"({ms / lib:.2f}x), bound {bound_ms:.3f} ms ({by}), relative error "
        f"{rel:.3e}, max |diff| {err:.3e}")
    del q, k, v, lib_fn
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                bound_by=by, max_abs_err=err)


def rel_frob(a, b) -> float:
    import torch
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def check_full_width_fp32(dev) -> None:
    """llama3.2-1b at full width in fp32 (seeded torch init): one prefill
    through the kernel and one through the plain chunked path; last-
    position logits and both caches within LM_F32_TOL, one flash_attention
    launch per layer."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import make_prefill_step
    cfg = dataclasses.replace(ARCHS[LM["arch"]], dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Transformer(cfg, device=dev, gen=gen)
    toks = torch.randint(0, cfg.vocab, (LM["parity_batch"],
                                        LM["parity_len"]),
                         generator=gen, device=dev)
    ops.reset_launch_counts()
    logits, cache = make_prefill_step(model)(toks)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_attention"]
    require(launches == cfg.n_layers
            == fa.launch_count_by_variant()["fma_fp32"],
            f"fp32 prefill launched flash_attention {launches} times "
            f"({fa.launch_count_by_variant()}), want {cfg.n_layers} of "
            f"fma_fp32")
    ref_logits, ref_cache = make_prefill_step(model, impl="ref")(toks)
    require(ops.launch_counts()["flash_attention"] == launches,
            "the ref prefill launched flash_attention")
    errs = {"logits": rel_frob(logits, ref_logits)}
    errs.update({name: rel_frob(cache[name], ref_cache[name])
                 for name in ("k", "v")})
    for name, e in errs.items():
        require(e <= LM_F32_TOL, f"fp32 full-width prefill: {name} relative "
                f"error {e:.3e} > {LM_F32_TOL}")
    log(f"[lm] {cfg.name} fp32 full width, prefill {LM['parity_batch']}x"
        f"{LM['parity_len']}: {launches} flash_attention launches; kernel vs "
        f"plain relative error " + ", ".join(f"{n} {e:.3e}"
                                             for n, e in errs.items()))
    del model, logits, cache, ref_logits, ref_cache
    torch.cuda.empty_cache()


def run_demo(arch: str, *extra: str):
    from repro_torch.launch import decode_demo
    argv = ["--arch", arch, *extra]
    log(f"[lm] decode_demo {' '.join(argv)}")
    return decode_demo.main(argv)


class RouteTape:
    """Teacher-forced MoE routing for a kernel-vs-plain comparison.
    While recording, every call of ``models.moe._top_k`` (one per MoE
    layer per forward or decode step) keeps its expert ids (and, with
    ``margins``, the k-th probability's lead over the (k+1)-th); after
    ``replay()`` each call returns the recorded ids, in the same order,
    with its own probabilities at them.  The router's choice is discrete:
    a rounding difference upstream (the kernel's against the plain
    attention's, in bf16) flips a near tie between the k-th and the
    (k+1)-th expert, and the flip carries through every later layer.
    Replayed, both paths route alike, so what they are compared on is
    the arithmetic of everything else.  Used as a context manager (it
    patches ``_top_k`` inside it only); recording costs one list append
    per call."""

    def __init__(self, margins: bool = False):
        from repro_torch.models import moe
        self._moe, self._top_k = moe, moe._top_k
        self.ids: list = []
        self.margins: list = []
        self._want_margins = margins
        self._next = None

    def __enter__(self):
        self._moe._top_k = self._call
        return self

    def __exit__(self, *exc):
        self._moe._top_k = self._top_k

    def replay(self) -> None:
        self._next = 0

    def replayed_all(self) -> bool:
        return self._next == len(self.ids)

    def _call(self, probs, k):
        if self._next is None:
            if not self._want_margins:
                vals, ids = self._top_k(probs, k)
                self.ids.append(ids)
                return vals, ids
            vals, ids = self._top_k(probs, k + 1)
            self.margins.append(vals[..., k - 1] - vals[..., k])
            self.ids.append(ids[..., :k])
            return vals[..., :k], ids[..., :k]
        ids = self.ids[self._next]
        self._next += 1
        return probs.gather(-1, ids), ids


class SdpaAttention:
    """A bf16 attention that involves no kernel of the port, for the
    free-routing comparison: inside it, every full-sequence attention
    call bound for the flash kernel (``kernels.ops.flash_attention``, on
    the same (b, h, s, d) views, scale and causality) runs torch's
    scaled_dot_product_attention instead.  Prefill only (q_offset 0, a
    causal call square).  Used as a context manager; nothing of the port
    calls it."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops
        F = torch.nn.functional
        self._ops, self._flash = ops, ops.flash_attention

        def sdpa(q, k, v, *, causal=True, q_offset=0, sm_scale=None,
                 impl="auto"):
            require(q_offset == 0 and (not causal
                                       or q.shape[2] == k.shape[2]),
                    f"SdpaAttention: q_offset {q_offset}, sq {q.shape[2]},"
                    f" skv {k.shape[2]}")
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=sm_scale, enable_gqa=True)

        ops.flash_attention = sdpa
        return self

    def __exit__(self, *exc):
        self._ops.flash_attention = self._flash


def _serve_again(res, impl: str):
    """``res``'s prompts prefilled through ``impl``, then decode steps
    from that cache fed ``res``'s tokens: (last-position logits, [each
    step's logits])."""
    import torch
    from repro_torch.train import make_prefill_step, make_serve_step
    model = res.model
    logits, filled = make_prefill_step(model, impl=impl)(res.prompts,
                                                         **res.inputs)
    T = res.tokens.shape[1] - 1
    serve = make_serve_step(model)
    with torch.inference_mode():
        cache = model.extend_cache(filled, res.start + T)
    del filled
    steps = []
    for t in range(T):
        step, cache = serve(cache, res.tokens[:, t:t + 1], res.start + t)
        steps.append(step)
    del cache
    return logits, steps


def _against(logits, steps, ref_logits, ref_steps, vocab):
    """(last-position error, largest step error, greedy tokens equal) of
    a run against a reference run fed the same tokens."""
    from repro_torch.models.model import greedy_sample
    errs = [rel_frob(a, b) for a, b in zip(steps, ref_steps)]
    same = sum(int((greedy_sample(a, vocab) == greedy_sample(b, vocab))
                   .sum()) for a, b in zip(steps, ref_steps))
    return rel_frob(logits, ref_logits), max(errs, default=0.0), same


def demo_vs_plain(res, tag: str, tape: RouteTape | None = None) -> dict:
    """``res``'s prompts through the plain chunked path (impl="ref"),
    which must launch no kernel: its last-position logits, and decode
    steps from its cache fed ``res``'s tokens, against them.  Returns
    {"free": (``res``'s prefill error, largest step error, greedy tokens
    equal) against the plain path}.  ``tape`` is the ``RouteTape`` that
    recorded ``res``'s own run; where it holds expert choices (an MoE
    model) the result also has "forced": the plain path run on those
    choices against ``res``; "sdpa": a bf16 path with no kernel
    (``SdpaAttention``), on its own routing, against the plain path, as
    "free"; per MoE layer of the prefill, "flipped" and "flipped_sdpa",
    the share of tokens whose top-k expert set differs from the plain
    path's, "dropped", (assignments ``res``'s prefill dropped past
    capacity, assignments), and "busiest", its busiest expert's load per
    group over the capacity, mean over groups; "margin0", (the plain
    path's median lead of the k-th over the (k+1)-th probability in the
    first MoE layer, the same over the tokens the kernel path flips
    there, their count)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    model, vocab = res.model, res.model.cfg.vocab
    ref_steps = list(res.step_logits.split(1, dim=1))
    before = ops.launch_counts()
    free_tape = RouteTape(margins=True)
    with free_tape:
        plain = _serve_again(res, "ref")
    require(ops.launch_counts() == before,
            f"{tag}: the plain prefill launched a kernel")
    out = {"free": _against(res.prefill_logits, ref_steps, *plain, vocab)}
    if tape is None or not tape.ids:
        return out
    tape.replay()
    with tape:
        forced = _serve_again(res, "ref")
    require(tape.replayed_all(), f"{tag}: the replay made "
            f"{tape._next} routing calls, the run {len(tape.ids)}")
    out["forced"] = _against(res.prefill_logits, ref_steps, *forced, vocab)
    del forced
    sdpa_tape = RouteTape()
    with SdpaAttention(), sdpa_tape:
        sdpa = _serve_again(res, "auto")
    require(ops.launch_counts() == before,
            f"{tag}: the scaled_dot_product_attention path launched a "
            f"kernel")
    out["sdpa"] = _against(*sdpa, *plain, vocab)
    del sdpa, plain

    L = sum(isinstance(m, moe.MoE) for m in model.modules())
    E = model.cfg.n_experts

    def flips(ids):
        return [(a.sort(-1).values != b.sort(-1).values).any(-1)
                for a, b in zip(free_tape.ids[:L], ids[:L])]

    flipped = flips(tape.ids)
    out["flipped"] = [float(f.float().mean()) for f in flipped]
    out["flipped_sdpa"] = [float(f.float().mean())
                           for f in flips(sdpa_tape.ids)]
    m0, f0 = free_tape.margins[0], flipped[0]
    out["margin0"] = (float(m0.median()),
                      float(m0[f0].median()) if bool(f0.any()) else None,
                      int(f0.sum()))
    out["dropped"], out["busiest"] = [], []
    for ids in tape.ids[:L]:
        G, gs, k = ids.shape
        C = moe.capacity(gs, k, E, moe.CAPACITY_FACTOR)
        onehot = F.one_hot(ids, E).float()
        kept = moe.slots(ids.reshape(-1, k), E, gs) < C
        out["dropped"].append((int((~kept).sum()), kept.numel()))
        out["busiest"].append(float(onehot.sum((1, 2)).amax(-1).mean()) / C)
    return out


def profile_lm(res, steps: int, top: int = 8, tag: str = "lm") -> None:
    """The cell's prefill once more, then ``steps`` decode steps fed the
    run's tokens, each under torch.profiler: wall, device busy time and
    idle share, and the ``top`` kernels by device time."""
    import torch
    from repro_torch.train import make_prefill_step, make_serve_step
    model, prompts = res.model, res.prompts
    prefill = make_prefill_step(model)
    serve = make_serve_step(model)
    out = {}
    wall, busy, events = profiled(lambda: out.update(
        zip(("logits", "cache"), prefill(prompts, **res.inputs))))
    windows = [("prefill", 1, wall, busy, events)]
    with torch.inference_mode():
        cache = model.extend_cache(out["cache"], res.start + steps)
    del out

    def decode():
        for t in range(steps):
            serve(cache, res.tokens[:, t:t + 1], res.start + t)

    windows.append(("decode", steps, *profiled(decode)))
    for label, n, wall, busy, events in windows:
        log(f"[{tag}] profiled {label} ({n} call(s)): wall "
            f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
            f"({100 * (1 - busy / wall):.1f}% idle)")
        if label == "prefill":
            attn = sum(e.device_time_total for e in events
                       if "flash_sm90" in e.key) / 1e6
            log(f"[{tag}]   attention (flash_sm90) {attn * 1e3:.3f} ms, "
                f"{100 * attn / busy:.1f}% of the device's busy time, "
                f"{100 * attn / wall:.1f}% of the wall")
        for e in events[:top]:
            log(f"[{tag}]   {e.device_time_total / 1e3 / n:9.4f} ms/call "
                f"{100 * e.device_time_total / 1e6 / busy:5.1f}%  "
                f"x{e.count:<5d} {e.key[:70]}")
    del cache
    torch.cuda.empty_cache()


def phase_lm(dev, smi: str) -> dict:
    """Phase 8 (see the module docstring); returns flash_attention's row of
    the kernels line."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    check_flash_grid(dev)
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
               replaces="src/repro/kernels/flash_attention.py:99",
               launches=0, max_abs_err=None, ms=None, plain_ms=None,
               bound_ms=None, bound_by=None, library_ms=None)
    row.update(time_flash(dev, FLASH_SCALES[0], reps=10, plain_reps=3))
    time_flash(dev, FLASH_SCALES[1], reps=3, plain_reps=1)
    check_full_width_fp32(dev)

    B, Pn, T = LM["batch"], LM["prompt"], LM["new_tokens"]
    run_demo(LM["arch"], "--batch", str(B), "--prompt-len", "256",
             "--new-tokens", "2")                      # warm-up, unchecked
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = run_demo(LM["arch"], "--batch", str(B), "--prompt-len", str(Pn),
                   "--new-tokens", str(T))
    launches = ops.launch_counts()
    cfg = res.model.cfg
    require(launches["flash_attention"] == cfg.n_layers
            == res.flash_launches,
            f"decode_demo launched flash_attention "
            f"{launches['flash_attention']} times, want {cfg.n_layers}")
    require(not any(n for name, n in launches.items()
                    if name != "flash_attention"),
            f"decode_demo launched other kernels: {launches}")
    by_variant = fa.launch_count_by_variant()
    require(by_variant == {"sm90_bf16": cfg.n_layers, "fma_fp32": 0},
            f"decode_demo's bf16 prefill launched {by_variant}, want "
            f"{cfg.n_layers} tensor-core (sm90_bf16) launches")
    row["launches"] = launches["flash_attention"]
    require(res.tokens.shape == (B, T + 1) and int(res.tokens.max())
            < cfg.vocab and int(res.tokens.min()) >= 0,
            "decode_demo: bad tokens")
    require(bool(torch.isfinite(res.prefill_logits).all())
            and bool(torch.isfinite(res.step_logits).all()),
            "decode_demo: non-finite logits")

    pre_err, step_err, same = demo_vs_plain(res, "decode_demo")["free"]
    require(pre_err <= LM_BF16_TOL, f"decode_demo: last-position logits "
            f"{pre_err:.3e} from the plain path (> {LM_BF16_TOL})")
    require(step_err <= LM_BF16_TOL, f"decode_demo: step logits "
            f"{step_err:.3e} from the plain path (> {LM_BF16_TOL})")
    log(f"[lm] {cfg.name} {cfg.dtype} full width ({smi}): prefill {B}x{Pn} "
        f"{res.prefill_ms:.1f} ms ({B * Pn / res.prefill_ms * 1e3:.0f} "
        f"tok/s); decode {T} steps {res.decode_ms / T:.2f} ms/step "
        f"({B * T / res.decode_ms * 1e3:.0f} tok/s); flash_attention "
        f"launches {launches['flash_attention']} (sm90_bf16 "
        f"{by_variant['sm90_bf16']}); peak device memory "
        f"{res.peak_bytes / 1e9:.2f} GB")
    log(f"[lm] kernel vs plain path: last-position logits relative error "
        f"{pre_err:.3e}; decode logits fed the kernel path's tokens, "
        f"largest relative error {step_err:.3e}; the plain path's "
        f"greedy token equals the kernel path's in {same} of {B * T}")
    MEASURED_PEAKS["llama3.2-1b serve"] = res.peak_bytes
    count_lm_steps(res, smi)
    profile_lm(res, min(16, T))
    del res
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phase 9: telemetry, the traced sweep and the traced serve stream
# ---------------------------------------------------------------------------

def check_trace(*args) -> str:
    """scripts/check_trace.py on a trace directory, as a subprocess; its
    OK line, or a PhaseError with its output."""
    out = subprocess.run([sys.executable,
                          str(ROOT / "scripts" / "check_trace.py"),
                          *map(str, args)], capture_output=True, text=True,
                         timeout=300)
    require(out.returncode == 0, f"check_trace.py {' '.join(map(str, args))}"
            f" exited {out.returncode}: {out.stdout[-2000:]}"
            f"{out.stderr[-2000:]}")
    return out.stdout.strip().splitlines()[-1]


def trace_events(trace_dir: Path) -> list[dict]:
    return [json.loads(line) for line in
            (trace_dir / "trace.jsonl").read_text().splitlines()]


def phase_telemetry(tmp: Path, sweep, served) -> None:
    """Phase 9: phase 3's sweep at TRACE_ITERS MU iterations, untraced and
    then with --trace and --sanitize, and phase 5's stream with --trace;
    ``sweep`` is phase 3's (result, report), ``served`` phase 5's kernel
    run."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.obs import trace as obs
    cfg = dict(FULL, iters=TRACE_ITERS)
    res3, rep3 = sweep
    # the traced sweep's result is held to the untraced one at the same
    # iterations (the selection at 30 iterations need not be phase 3's)
    base, base_rep = run_sweep(tmp / "planted.npz", tmp / "untraced.json",
                               "auto", cfg)
    tdir, report = tmp / "trace_sweep", tmp / "traced.json"
    # memory.json's device peak is the allocator's since this reset: the
    # traced run's own, not this process's since phase 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res, rep = run_sweep(tmp / "planted.npz", report, "auto", cfg,
                         "--trace", str(tdir), "--sanitize")
    launches = ops.launch_counts()
    log(f"[telemetry] kernel launches in the traced run: {launches}; the "
        f"report's (the sweep alone): {rep.meta['kernel_launches']}")
    for name in ("bcsr_xa_xta", "bcsr_spmm", "mu_update_a"):
        require(launches[name] > 0, f"{name} was not launched in the "
                f"traced sweep")
    n_ks = cfg["k_max"] - cfg["k_min"] + 1
    require(rep.meta["kernel_launches"]["mu_update_a"]
            == n_ks * cfg["iters"], "the report's mu_update_a count is not "
            "one per MU iteration")
    check_sweep(res, report, cfg)
    ok = check_trace(tdir, "--report", report, "--expect-metrics",
                     "--expect-memory")
    log(f"[telemetry] {ok}")
    led = json.loads((tdir / "memory.json").read_text())
    peak = led["runtime"]["peak_device_bytes"]
    stored = led["ledger"]["resident_bytes"]
    require(peak is not None and peak >= stored,
            f"peak_device_bytes {peak} below the resident operand {stored}")
    per_k = led["per_k"]
    require(sorted(per_k) == [str(k) for k in res.ks],
            f"per_k covers {sorted(per_k)}")
    for k, e in per_k.items():
        require(bool(e) and e["peak"] >= max(e["argument"], e["output"],
                                             e["temp"]),
                f"per_k[{k}] {e}")
    require(all(u.peak_device_bytes and u.peak_device_bytes > 0
                for u in rep.units), "a unit has no device peak")
    want = (n_ks * cfg["iters"] * cfg["r"],)
    with np.load(tdir / "metrics.npz") as d:
        rel = d["core.sparse.sparse_mu_step.rel_error"]
        require(rel.shape == want and bool(np.isfinite(rel).all()),
                f"rel_error trajectory {rel.shape}, want {want}")
        mu = d["core.sparse.sparse_mu_step.mu_ratio"]
        log(f"[telemetry] metrics.npz: {sorted(d.files)}; rel_error "
            f"{rel.shape}, first {rel[:4].round(6).tolist()} last "
            f"{rel[-4:].round(6).tolist()}; mu_ratio last "
            f"{mu[-4:].round(6).tolist()}")
    require(res.k_opt == base.k_opt, f"traced k_opt {res.k_opt}, untraced "
            f"{base.k_opt}")
    for name in ("s_min", "s_mean", "rel_err"):
        worst = float(np.abs(getattr(res, name) - getattr(base, name)).max())
        require(worst <= SWEEP_TOL, f"traced {name} differs from the "
                f"untraced run's by {worst:.2e}")
    log(f"[telemetry] k_opt {res.k_opt} traced and untraced at "
        f"{cfg['iters']} MU iterations (phase 3, {FULL['iters']}: "
        f"{res3.k_opt}); per-k values within {SWEEP_TOL}")
    log(f"[telemetry] memory.json: peak_device_bytes {peak} "
        f"({peak / 1e9:.2f} GB), peak_host_bytes "
        f"{led['runtime']['peak_host_bytes']}, per_k "
        + "; ".join(f"k={k}: arg {e['argument']} out {e['output']} temp "
                    f"{e['temp']} peak {e['peak']}"
                    for k, e in sorted(per_k.items())))
    log("[telemetry] summary.txt:\n" + (tdir / "summary.txt").read_text())
    traced = ms_per_iteration(rep, cfg["iters"])
    plain = ms_per_iteration(base_rep, cfg["iters"])
    plain3 = ms_per_iteration(rep3, FULL["iters"])
    log(f"[telemetry] per MU iteration at {cfg['iters']} iterations: "
        f"traced {traced:.2f} ms, untraced {plain:.2f} ms: overhead "
        f"{100 * (traced / plain - 1):.1f}%; phase 3 untraced at "
        f"{FULL['iters']}: {plain3:.2f} ms, against the recorded "
        f"{RECORDED_BCSR_MS} ms: "
        f"{100 * (plain3 / RECORDED_BCSR_MS - 1):+.1f}%")
    profile_traced_step(torch.device("cuda"))

    # the stream untraced, then traced, in this phase's conditions (after
    # the sweeps above), beside phase 5's untraced run
    sdir = tmp / "trace_serve"
    plain = run_serve(tmp / "cuda.bundle", "auto")
    ops.reset_launch_counts()
    got = run_serve(tmp / "cuda.bundle", "auto", "--trace", str(sdir))
    require(ops.launch_counts()["score_topk"] == got.stats["batches"],
            "score_topk launches differ from the device batches")
    log(f"[telemetry] {check_trace(sdir)}")
    events = trace_events(sdir)
    begins = [e["name"] for e in events if e["ph"] == "B"]
    require(begins.count("serve/request") == SERVE["requests"],
            f"{begins.count('serve/request')} serve/request spans")
    require(begins.count("serve/score") == got.stats["batches"],
            f"{begins.count('serve/score')} serve/score spans for "
            f"{got.stats['batches']} batches")
    require(got.stats == served.stats == plain.stats,
            f"traced stats {got.stats}, untraced {plain.stats}, phase 5's "
            f"{served.stats}")
    for name in ("serve/request", "serve/score"):
        durs = np.array([e["dur"] / 1e3 for e in events
                         if e["ph"] == "E" and e["name"] == name])
        log(f"[telemetry] {name} spans: {len(durs)}, p50 "
            f"{np.percentile(durs, 50):.3f} ms, max {durs.max():.3f} ms, "
            f"total {durs.sum():.3f} ms")
    for out, tag in ((plain, "untraced"), (got, "traced")):
        log(f"[telemetry] serve {tag}: {len(out.results) / out.seconds:.1f} "
            f"q/s; request ms "
            f"{[round(float(x) * 1e3, 3) for x in out.latencies]}")
    log(f"[telemetry] serve: traced {len(got.results) / got.seconds:.1f} "
        f"q/s, untraced {len(plain.results) / plain.seconds:.1f} q/s, "
        f"phase 5 untraced {len(served.results) / served.seconds:.1f} "
        f"q/s; {SERVE['requests']} request and {got.stats['batches']} "
        f"score spans")
    # rounds of four: the records' cost apart from the spread between
    # streams (requests 2-16; the first pays the engine's set-up)
    p50 = {"untraced": [], "traced to a file": [], "traced in memory": []}
    for rnd in range(TRACE_ROUNDS):
        for tag in ("untraced", "traced to a file", "traced in memory",
                    "untraced"):
            tracer = (None if tag == "untraced" else obs.Tracer(
                str(tmp / f"trace_round{rnd}") if "file" in tag else None))
            prev = obs.install(tracer)
            try:
                out = run_serve(tmp / "cuda.bundle", "auto")
            finally:
                obs.install(prev)
                if tracer is not None:
                    tracer.close()
            require(out.stats == plain.stats, f"{tag} stats {out.stats}")
            p50[tag].append(1e3 * float(np.median(out.latencies[1:])))
    log("[telemetry] serve rounds, request p50 of requests 2-"
        f"{SERVE['requests']} (ms), median over runs: "
        + "; ".join(f"{tag} {np.median(v):.3f} (runs "
                    f"{[round(x, 3) for x in v]})" for tag, v in p50.items()))
    on_disk, in_memory = record_us(tmp / "trace_cost"), record_us(None)
    log(f"[telemetry] one trace record costs {on_disk:.1f} us written to "
        f"trace.jsonl here, {in_memory:.1f} us in memory only")


def profile_traced_step(dev) -> None:
    """One k = 5 MU iteration at the BCSR sweep's shape (r = 4 members,
    random stored values), untraced and as ``--trace --sanitize`` runs it
    (metrics recorded into a buffer, the factors checked): ms per
    iteration by CUDA events, then the traced iteration's device time by
    kernel from torch.profiler."""
    import torch
    from repro_torch.core.sparse import sparse_mu_step
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.obs import metrics
    n, m, bs, r, k = FULL["n"], FULL["m"], FULL["bs"], FULL["r"], 5
    _, rows, cols = main_pattern(n, bs, FULL["off_density"], FULL["seed"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sp = pattern_bcsr(rows.tolist(), cols.tolist(), n, bs, m, r, gen, dev)
    A = torch.rand((r, n, k), generator=gen, device=dev) + 0.05
    R = torch.rand((r, m, k, k), generator=gen, device=dev) + 0.05
    policy = KernelPolicy(use_fused=True, impl="auto")

    def step(traced: bool):
        sparse_mu_step(sp, A, R, policy=policy, sanitize=traced,
                       trace_metrics=traced)

    prev = metrics.install_buffer(metrics.MetricsBuffer())
    try:
        plain = cuda_ms(lambda: step(False), reps=TRACE_PROFILE_REPS)
        traced = cuda_ms(lambda: step(True), reps=TRACE_PROFILE_REPS)
        wall, busy, events = profiled(
            lambda: [step(True) for _ in range(TRACE_PROFILE_REPS)])
    finally:
        metrics.install_buffer(prev)
    reps = TRACE_PROFILE_REPS
    log(f"[telemetry] one k={k} MU iteration at the sweep's shape (r={r}, "
        f"nnzb={len(rows)}): untraced {plain:.3f} ms, traced + sanitized "
        f"{traced:.3f} ms (CUDA events, {reps} iterations); traced, device "
        f"busy {busy / reps * 1e3:.3f} ms of {wall / reps * 1e3:.3f} ms "
        f"wall (torch.profiler)")
    for e in events[:10]:
        log(f"[telemetry]   {e.device_time_total / 1e3 / reps:8.3f} ms "
            f"{100 * e.device_time_total / 1e6 / busy:5.1f}%  "
            f"x{e.count // reps:<3d} {e.key[:80]}")
    del sp, A, R
    torch.cuda.empty_cache()


def record_us(out_dir: Path | None, spans: int = 2000) -> float:
    """Host microseconds per trace record: ``spans`` empty spans (two
    records each) through a Tracer writing to ``out_dir`` (each record is
    written and flushed at once), or keeping them in memory."""
    from repro_torch.obs import trace as obs
    tracer = obs.Tracer(None if out_dir is None else str(out_dir))
    t0 = time.perf_counter()
    for _ in range(spans):
        with tracer.span("serve/score", batch=32, live=32):
            pass
    seconds = time.perf_counter() - t0
    tracer.close()
    return 1e6 * seconds / (2 * spans)


# ---------------------------------------------------------------------------
# Phase 10: the virtual and sharded sparse operand
# ---------------------------------------------------------------------------

def run_virtual_cli(tmp: Path, name: str, cfg: dict, impl: str):
    """One sweep through ``rescalk_run.main`` on a virtual spec; returns
    (result, report, launches of this run)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import rescalk_run
    argv = ["--data", cfg["spec"], "--k-min", str(cfg["k_min"]),
            "--k-max", str(cfg["k_max"]), "--r", str(cfg["r"]),
            "--iters", str(cfg["iters"]), "--use-fused-kernel",
            "--fused-impl", impl, "--report", str(tmp / f"{name}.json")]
    log(f"[virtual] rescalk_run {' '.join(argv)}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, rep = rescalk_run.main(argv)
    launches = ops.launch_counts()
    require(rep.meta["n_kernel_fallbacks"] == 0,
            f"{name} fell back to a plain version: {rep.meta}")
    log(f"[virtual] {name}: {time.perf_counter() - t0:.1f}s wall; per MU "
        f"iteration {ms_per_iteration(rep, cfg['iters']):.2f} ms; launches "
        f"{launches}")
    check_sweep(res, tmp / f"{name}.json", cfg)
    return res, rep, launches


def per_k_table(res) -> str:
    return "; ".join(f"k={int(k)} s_min={a:.4f} s_mean={b:.4f} "
                     f"rel_err={c:.4f}" for k, a, b, c in
                     zip(res.ks, res.s_min, res.s_mean, res.rel_err))


def time_shard(sp, A, reps: int = 20) -> tuple[float, float]:
    """bcsr_xa_xta and bcsr_spmm on one shard: ms per call."""
    from repro_torch.kernels import bcsr_fused, bcsr_spmm
    return (cuda_ms(lambda: bcsr_fused.bcsr_xa_xta(sp, A, A), reps=reps),
            cuda_ms(lambda: bcsr_spmm.bcsr_spmm(sp, A), reps=reps))


def check_partition(tmp: Path, dev) -> None:
    """(c): phase 3's file balanced onto a 2 x 2 layout; every shard,
    front-padded, through both BCSR kernels against their plain versions,
    and timed with and without its padding; then the manifest of the
    skewed grid-2 spec."""
    import numpy as np
    import torch
    from repro_torch.core.sparse import BCSR
    from repro_torch.io import (VirtualSpec, coo_to_bcsr, ingest_npz,
                                manifest_of, partition_coo)
    from repro_torch.kernels import bcsr_fused, bcsr_spmm, ref
    coo = ingest_npz(str(tmp / "planted.npz"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh = partition_coo(coo, bs=FULL["bs"], grid=PARTITION_GRID, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"[virtual] partition_coo of phase 3's file (nnz {coo.nnz}) onto "
        f"grid={PARTITION_GRID}: {secs:.2f}s; balance {sh.balance:.4f}; "
        f"shard nnzb {sh.nnzb.reshape(-1).tolist()}; z_max {sh.z_max}; "
        f"resident {sh.resident_bytes / 1e9:.3f} GB")
    whole = coo_to_bcsr(coo, bs=FULL["bs"], device=dev)
    merged = sh.to_bcsr()
    del coo
    require(merged.nnzb == whole.nnzb == sh.nnzb_total,
            f"to_bcsr has {merged.nnzb} blocks, phase 3's BCSR "
            f"{whole.nnzb}")
    s_m = float(torch.sum(merged.data, dtype=torch.float64))
    s_w = float(torch.sum(whole.data, dtype=torch.float64))
    require(abs(s_m - s_w) <= 1e-9 * abs(s_w),
            f"to_bcsr's sum {s_m!r} differs from phase 3's {s_w!r}")
    log(f"[virtual] to_bcsr: {merged.nnzb} stored blocks (phase 3's "
        f"{whole.nnzb}), sum {s_m:.6f} (phase 3's {s_w:.6f})")
    del merged, whole
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for i in range(sh.g):
        for j in range(sh.g):
            sp = sh.shard(i, j)
            pad = sh.z_max - int(sh.nnzb[i, j])
            # the same shard without its padding (a contiguous copy)
            real = BCSR(data=sp.data[:, pad:].contiguous(),
                        block_rows=sp.block_rows[pad:],
                        block_cols=sp.block_cols[pad:], n=sp.n)
            for k in PADDING_KS:
                A = torch.rand((sp.n, k), generator=gen, device=dev)
                xa, xt = bcsr_fused.bcsr_xa_xta(sp, A, A)
                sa = bcsr_spmm.bcsr_spmm(sp, A)
                torch.cuda.synchronize()
                ra, rt = ref.ref_bcsr_xa_xta(sp, A, A)
                tag = f"shard ({i}, {j}), {pad} padding blocks, k={k}"
                compare(f"bcsr_xa_xta XA [{tag}]", xa, ra)
                compare(f"bcsr_xa_xta XTB [{tag}]", xt, rt)
                compare(f"bcsr_spmm [{tag}]", sa, ra)
                del xa, xt, sa, ra, rt
                f_ms, s_ms = time_shard(sp, A)
                f_real, s_real = time_shard(real, A)
                log(f"[virtual] {tag}: bcsr_xa_xta {f_ms:.4f} ms "
                    f"({f_real:.4f} without the padding), bcsr_spmm "
                    f"{s_ms:.4f} ms ({s_real:.4f}); both held to their "
                    f"plain versions")
            del sp, real
    del sh
    torch.cuda.empty_cache()
    spec = VirtualSpec.parse(VIRTUAL_SKEW)
    t0 = time.perf_counter()
    man = manifest_of(spec)
    nnzb = np.array(man.nnzb)
    log(f"[virtual] manifest_of({VIRTUAL_SKEW}) in "
        f"{time.perf_counter() - t0:.2f}s (index only): shard nnzb "
        f"{nnzb.tolist()}, identity-layout imbalance "
        f"{nnzb.max() * nnzb.size / nnzb.sum():.4f}, logical "
        f"{man.logical_bytes / 2**30:.2f} GiB, resident "
        f"{man.resident_bytes / 1e9:.3f} GB")


def phase_virtual(tmp: Path, rep3, dev, smi: str) -> None:
    """Phase 10 (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.core.rescalk import rescalk
    from repro_torch.dist.engine import DistRescalConfig, dist_rescal
    from repro_torch.io import VirtualSpec, manifest_of, virtual_sharded_bcsr
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch.mesh import make_grid
    from repro_torch.selection import RescalkConfig
    cfg = VIRTUAL
    log(f"[virtual] on {smi}")
    spec = VirtualSpec.parse(cfg["spec"])
    man = manifest_of(spec)
    nnzb = int(man.nnzb[0])
    per_block = cfg["m"] * cfg["bs"] ** 2 * 4
    log(f"[virtual] {cfg['spec']}: {nnzb} stored blocks, logical "
        f"{man.logical_bytes} B ({man.logical_bytes / 2**30:.2f} GiB), "
        f"resident {man.resident_bytes} B ({man.resident_bytes / 1e9:.3f} "
        f"GB), {man.compression:.1f}x")
    require(man.logical_bytes == cfg["m"] * cfg["n"] ** 2 * 4,
            "logical bytes")
    require(man.resident_bytes == nnzb * (per_block + 8), "resident bytes")
    require(5900 <= nnzb <= 6600, f"{nnzb} stored blocks, expected ~6262")

    # (a) the sweep through the CLI, kernels then plain
    torch.cuda.reset_peak_memory_stats(dev)
    res, rep, launches = run_virtual_cli(tmp, "virtual_cuda", cfg, "auto")
    peak = torch.cuda.max_memory_allocated(dev)
    want = (cfg["k_max"] - cfg["k_min"] + 1) * cfg["iters"]
    for name in ("bcsr_xa_xta", "bcsr_spmm"):
        require(launches[name] > 0, f"{name} was not launched")
    require(launches["mu_update_a"] == want,
            f"mu_update_a launched {launches['mu_update_a']} times, want "
            f"{want}")
    ms_a = MS_PER_ITER["phase 10 (a)"] = ms_per_iteration(rep, cfg["iters"])
    log(f"[virtual] (a) k_opt {res.k_opt} against the planted "
        f"{cfg['k_true']}; {per_k_table(res)}")
    log(f"[virtual] (a) per MU iteration {ms_a:.2f} ms (phase 3: "
        f"{ms_per_iteration(rep3, FULL['iters']):.2f} ms); device peak "
        f"{peak / 1e9:.2f} GB")
    ref, rep_ref, launches_ref = run_virtual_cli(tmp, "virtual_ref", cfg,
                                                 "ref")
    require(not any(launches_ref.values()), "the ref sweep launched a kernel")
    require(res.k_opt == ref.k_opt,
            f"k_opt differs: kernel {res.k_opt}, ref {ref.k_opt}")
    for name in ("s_min", "s_mean", "rel_err"):
        worst = float(np.abs(getattr(res, name) - getattr(ref, name)).max())
        log(f"[virtual] (a) {name}: kernel vs ref max |diff| {worst:.2e}")
        require(worst <= SWEEP_TOL, f"{name} differs by {worst:.2e}")
    log(f"[virtual] (a) ref per MU iteration "
        f"{ms_per_iteration(rep_ref, cfg['iters']):.2f} ms")

    # (b) the same operand on a 1 x 1 NCCL grid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = virtual_sharded_bcsr(spec, device=dev)
    torch.cuda.synchronize()
    log(f"[virtual] virtual_sharded_bcsr: {sharded.nnzb_total} blocks, "
        f"{sharded.data.numel() * 4 / 1e9:.3f} GB generated in "
        f"{time.perf_counter() - t0:.2f}s")
    grid = make_grid(data=1, model=1, device=dev)
    try:
        cell = sharded.cell(0, 0)
        rc = RescalkConfig(k_min=cfg["k_min"], k_max=cfg["k_max"],
                           n_perturbations=cfg["r"],
                           rescal_iters=cfg["iters"],
                           kernel=KernelPolicy(use_fused=True))
        ops.reset_launch_counts()
        c0 = grid.collectives
        t0 = time.perf_counter()
        gres = rescalk(cell, rc, grid=grid,
                       report_path=str(tmp / "virtual_grid.json"))
        glaunch = ops.launch_counts()
        grid_doc = json.loads((tmp / "virtual_grid.json").read_text())
        require(grid_doc["meta"]["n_kernel_fallbacks"] == 0,
                "the virtual grid sweep fell back to a plain version")
        units = grid_doc["units"]
        ms_b = MS_PER_ITER["phase 10 (b)"] = 1e3 * sum(
            u["seconds"] for u in units) / (len(units) * cfg["iters"])
        log(f"[virtual] (b) 1 x 1 grid sweep: "
            f"{time.perf_counter() - t0:.1f}s wall, per MU iteration "
            f"{ms_b:.2f} ms, launches {glaunch}, collectives "
            f"{grid.collectives - c0}")
        for name in ("bcsr_xa_xta", "mu_update_a"):
            require(glaunch[name] == want, f"grid: {name} launched "
                    f"{glaunch[name]} times, want {want}")
        require(grid.collectives > c0, "the grid issued no collective")
        require(gres.k_opt == res.k_opt,
                f"grid k_opt {gres.k_opt}, single device {res.k_opt}")
        for name in ("s_min", "s_mean", "rel_err"):
            worst = float(np.abs(getattr(gres, name)
                                 - getattr(res, name)).max())
            log(f"[virtual] (b) {name}: grid vs single device max |diff| "
                f"{worst:.2e}")
            require(worst <= SWEEP_TOL, f"grid {name} differs by "
                                        f"{worst:.2e}")
        out = {}
        for impl in ("auto", "ref"):
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            st, err = dist_rescal(
                cell.sp, cfg["sliced_k"], grid, generator=gen,
                iters=cfg["sliced_iters"],
                cfg=DistRescalConfig(schedule="sliced", kernel=KernelPolicy(
                    use_fused=True, impl=impl)))
            torch.cuda.synchronize()
            out[impl] = st
            n_l = ops.launch_counts()["bcsr_xa_xta"]
            log(f"[virtual] (b) dist_rescal sliced impl={impl}: "
                f"{cfg['sliced_iters']} iterations in "
                f"{time.perf_counter() - t0:.2f}s, rel_err {float(err):.6f}, "
                f"bcsr_xa_xta launches {n_l}")
            if impl == "auto":
                require(n_l == cfg["m"] * cfg["sliced_iters"],
                        "the sliced schedule did not launch m times per "
                        "iteration")
        for name in ("A", "R"):
            a, b = getattr(out["auto"], name), getattr(out["ref"], name)
            rel = float((a - b).abs().max() / b.abs().max())
            log(f"[virtual] (b) dist_rescal sliced {name}: max |diff| / max "
                f"|ref| {rel:.2e}")
            require(bool(torch.isfinite(a).all()) and rel <= SWEEP_TOL,
                    f"dist_rescal sliced {name} differs by {rel:.2e}")
        del cell, out
    finally:
        grid.destroy()
    del sharded
    torch.cuda.empty_cache()

    # (c) the balancer and front-padded shards at full size
    check_partition(tmp, dev)

    # (d) the planted rank at a small size
    small = VIRTUAL_SMALL
    sres, _, _ = run_virtual_cli(tmp, "virtual_small", small, "auto")
    log(f"[virtual] (d) {small['spec']}: k_opt {sres.k_opt} (planted "
        f"{small['k_true']}); {per_k_table(sres)}")
    require(sres.k_opt == small["k_true"],
            f"the small virtual spec selected k={sres.k_opt}, planted "
            f"{small['k_true']}")


# ---------------------------------------------------------------------------
# Phase 11: checkpoints, retry and faults; the chaos drill at full width
# ---------------------------------------------------------------------------

def span_seconds(tracer, name: str) -> dict[str, float]:
    """Seconds of each ``name`` span in an in-memory trace, by unit uid."""
    return {e["args"]["uid"]: e["dur"] / 1e6 for e in tracer.events
            if e.get("ph") == "E" and e.get("name") == name}


def drill_argv(cfg: dict) -> list[str]:
    return ["--data", cfg["spec"], "--k-min", str(cfg["k_min"]),
            "--k-max", str(cfg["k_max"]), "--r", str(cfg["r"]),
            "--iters", str(cfg["iters"]), "--use-fused-kernel"]


def same_report(tag: str, a, b) -> None:
    """Bit-identical curves, k_opt and units (execution telemetry aside)."""
    for name in ("ks", "s_min", "s_mean", "rel_err", "k_opt"):
        require(getattr(a, name) == getattr(b, name),
                f"{tag}: {name} differs: {getattr(a, name)} against "
                f"{getattr(b, name)}")
    require([(u.uid, u.k, u.members) for u in a.units]
            == [(u.uid, u.k, u.members) for u in b.units],
            f"{tag}: the units differ")


def phase_chaos(tmp: Path, dev, smi: str) -> None:
    """Phase 11 (see the module docstring)."""
    import warnings
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import rescalk_run
    from repro_torch.obs import trace as obs
    cfg = DRILL
    log(f"[chaos] on {smi}")
    argv = drill_argv(cfg)
    n_units = cfg["k_max"] - cfg["k_min"] + 1
    want = n_units * cfg["iters"]

    # (a) in this process: the sweep under deterministic algorithms
    # (warnings recorded), then with --ckpt-dir, then its resume
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            _, rep0 = rescalk_run.main(argv + ["--report",
                                               str(tmp / "chaos0.json")])
            wall0 = time.perf_counter() - t0
            launches = ops.launch_counts()
    finally:
        torch.use_deterministic_algorithms(False)
    for name in ("bcsr_xa_xta", "bcsr_spmm"):
        require(launches[name] > 0, f"{name} was not launched")
    require(launches["mu_update_a"] == want,
            f"mu_update_a launched {launches['mu_update_a']} times, want "
            f"{want}")
    notes = sorted({str(w.message)[:200] for w in caught})
    require(not notes, f"warnings under use_deterministic_algorithms: "
                       f"{notes}")
    log(f"[chaos] (a) sweep under torch.use_deterministic_algorithms("
        f"True, warn_only=True): no warning; {wall0:.1f}s wall, launches "
        f"{launches}")
    ck = tmp / "chaos_ck"
    tracer = obs.Tracer(None)
    prev = obs.install(tracer)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, rep1 = rescalk_run.main(argv + ["--ckpt-dir", str(ck), "--report",
                                           str(tmp / "chaos1.json")])
        wall1 = time.perf_counter() - t0
        launches1 = ops.launch_counts()
        t0 = time.perf_counter()
        _, rep2 = rescalk_run.main(argv + ["--ckpt-dir", str(ck), "--report",
                                           str(tmp / "chaos2.json")])
        wall2 = time.perf_counter() - t0
    finally:
        obs.install(prev)
    require(launches1 == launches, f"the checkpointed sweep launched "
                                   f"{launches1}, the plain one {launches}")
    same_report("--ckpt-dir against the plain sweep", rep1, rep0)
    same_report("the resume against the plain sweep", rep2, rep0)
    require(rep2.n_reused == n_units,
            f"the resume reused {rep2.n_reused} of {n_units} units")
    for rep in (rep0, rep1, rep2):
        require(rep.meta["n_kernel_fallbacks"] == 0,
                f"a fault-free sweep fell back: {rep.meta}")
    saves = span_seconds(tracer, "sched/checkpoint")
    loads = span_seconds(tracer, "sched/restore")
    for u in rep1.units:
        size = (ck / u.uid / "step_0.npz").stat().st_size
        log(f"[chaos] {u.uid}: checkpoint {size} B, save "
            f"{saves[u.uid]:.4f}s, restore {loads[u.uid]:.4f}s, unit "
            f"{u.seconds:.3f}s")
    iters = n_units * cfg["iters"]
    plain_ms = 1e3 * rep0.total_seconds / iters
    ckpt_ms = 1e3 * (rep1.total_seconds + sum(saves.values())) / iters
    log(f"[chaos] per MU iteration: {plain_ms:.3f} ms without --ckpt-dir, "
        f"{ckpt_ms:.3f} ms with it (unit seconds plus the checkpoint "
        f"writes); wall {wall0:.1f}s, {wall1:.1f}s, resume {wall2:.1f}s")

    # (b) the drill: every phase a CLI process on the card
    work = tmp / "drill"
    cmd = [sys.executable, str(ROOT / "scripts" / "torch_chaos_drill.py"),
           "--device", "cuda", "--workdir", str(work), "--", *argv]
    log(f"[chaos] (b) {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=DRILL_TIMEOUT)
    for line in proc.stdout.splitlines():
        log(f"[chaos]   {line}")
    require(proc.returncode == 0,
            f"the chaos drill exited {proc.returncode}:\n"
            f"{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.split("[chaos-drill] summary ")[1]
                         .splitlines()[0])
    for path in sorted(work.glob("r*.json")):
        doc = json.loads(path.read_text())
        fb = doc["meta"]["n_kernel_fallbacks"]
        require(fb == (1 if path.name == "r5.json" else 0),
                f"{path.name}: n_kernel_fallbacks {fb}")
        launched = doc["meta"]["kernel_launches"]
        require(launched["bcsr_xa_xta"] > 0 and launched["mu_update_a"] > 0,
                f"{path.name}: the kernels were not launched: {launched}")
    require(summary["kill_reused"] >= 1, f"the SIGKILL resume reused "
                                         f"nothing: {summary}")
    log(f"[chaos] (b) drill passed in {time.perf_counter() - t0:.1f}s: "
        f"k_opt {summary['k_opt']}; the forced overflow's unit took "
        f"{summary['overflow_attempts']} attempts; SIGKILL after "
        f"{summary['kill_after_s']:.1f}s, {summary['kill_reused']} of "
        f"{summary['kill_units']} units reused; {json.dumps(summary)}")
    for key, old in RECORDED_MS.items():
        now = MS_PER_ITER.get(key)
        log(f"[chaos] {key}: {now:.2f} ms per MU iteration (recorded: "
            f"{old:.2f}) on {smi}" if now is not None else
            f"[chaos] {key}: not run")


# ---------------------------------------------------------------------------
# Phase 12: the resilient sweep on the process grid (1 x 1 NCCL)
# ---------------------------------------------------------------------------

def sweep_config(cfg: dict):
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.selection import RescalkConfig
    return RescalkConfig(k_min=cfg["k_min"], k_max=cfg["k_max"],
                         n_perturbations=cfg["r"], rescal_iters=cfg["iters"],
                         regress_iters=cfg["regress_iters"],
                         seed=cfg["seed"], kernel=KernelPolicy(use_fused=True))


def grid_sweep(tag: str, grid, X, cfg: dict, *, launches_of=None, **kw):
    """One ``SweepScheduler(grid=grid)`` sweep with the counters zeroed
    just before and read just after; returns (result, report, launches,
    collectives, agreements)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.selection import SweepScheduler
    sched = SweepScheduler(sweep_config(cfg), grid=grid, **kw)
    agree, n_agree = grid.agree, [0]

    def counted(*a, **k):
        n_agree[0] += 1
        return agree(*a, **k)

    grid.agree = counted
    try:
        ops.reset_launch_counts()
        c0 = grid.collectives
        t0 = time.perf_counter()
        res = sched.run(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        del grid.agree
    rep = sched.report
    computed = [u for u in rep.units if not u.reused]
    iters = len(computed) * cfg["iters"]
    ms = 1e3 * sum(u.seconds for u in computed) / iters if iters else 0.0
    collectives = grid.collectives - c0
    log(f"[gridsweep] {tag}: {wall:.1f}s wall, {len(computed)} units "
        f"computed, {rep.n_reused} reused; per MU iteration {ms:.3f} ms; "
        f"launches {launches}; collectives {collectives} "
        f"({collectives / len(rep.units):.1f} per unit, of which "
        f"{3 * n_agree[0] / len(rep.units):.1f} in {n_agree[0]} agreements)")
    if launches_of is not None:
        for name in launches_of:
            require(launches[name] == iters,
                    f"{tag}: {name} launched {launches[name]} times, want "
                    f"{iters} (one per MU iteration per unit or chunk)")
    require(rep.meta["mesh"] == grid.shape, f"{tag}: meta mesh "
                                            f"{rep.meta['mesh']}")
    return res, rep, launches, ms


def same_result(tag: str, a, b) -> None:
    """Bit-identical curves, k_opt and per-k factors."""
    import numpy as np
    require(a.k_opt == b.k_opt, f"{tag}: k_opt {a.k_opt} against {b.k_opt}")
    for name in ("s_min", "s_mean", "rel_err"):
        require(np.array_equal(getattr(a, name), getattr(b, name)),
                f"{tag}: {name} differs: {getattr(a, name)} against "
                f"{getattr(b, name)}")
    for k in a.per_k:
        for name in ("A_median", "R_regress", "member_errors"):
            require(np.array_equal(getattr(a.per_k[k], name),
                                   getattr(b.per_k[k], name)),
                    f"{tag}: k={k} {name} differs")


def close_curves(tag: str, a, b, tol: float = SWEEP_TOL) -> None:
    import numpy as np
    require(a.k_opt == b.k_opt, f"{tag}: k_opt {a.k_opt} against {b.k_opt}")
    worst = max(float(np.abs(getattr(a, n) - getattr(b, n)).max())
                for n in ("s_min", "s_mean", "rel_err"))
    log(f"[gridsweep] {tag}: k_opt {a.k_opt}; per-k max |diff| "
        f"{worst:.2e}")
    require(worst <= tol, f"{tag}: per-k values differ by {worst:.2e}")


def check_masked(tag: str, ck: Path, units) -> None:
    """Every cell of every chunk checkpoint has exact zeros past its
    k."""
    for u in units:
        arrays = ckpt_arrays(ck / u.uid)
        for i, (k, _) in enumerate(u.cells):
            require(not arrays["A"][i, :, k:].any()
                    and not arrays["R"][i, :, k:].any()
                    and not arrays["R"][i, :, :, k:].any(),
                    f"{tag}: {u.uid} cell {i} has non-zero masked columns")
    log(f"[gridsweep] {tag}: masked columns exactly 0 in all "
        f"{sum(len(u.cells) for u in units)} cells")


def ckpt_arrays(tag: Path) -> dict:
    import numpy as np
    with np.load(tag / "step_0.npz") as z:
        return {name: z[name] for name in z.files}


def ckpt_table(tag: str, tracer, ck: Path, rep) -> None:
    saves = span_seconds(tracer, "sched/checkpoint")
    loads = span_seconds(tracer, "sched/restore")
    for u in rep.units:
        path = ck / u.uid / "step_0.npz"
        log(f"[gridsweep] {tag} {u.uid}: checkpoint "
            f"{path.stat().st_size} B, save {saves.get(u.uid, 0.0):.4f}s, "
            f"restore {loads.get(u.uid, 0.0):.4f}s, unit {u.seconds:.3f}s, "
            f"attempts {u.attempts}")


def phase_grid_sweep(tmp: Path, dev, smi: str) -> None:
    """Phase 12 (see the module docstring)."""
    import torch
    from repro_torch.data.synthetic import synthetic_rescal
    from repro_torch.io import VirtualSpec, virtual_sharded_bcsr
    from repro_torch.launch.mesh import make_grid
    from repro_torch.obs import trace as obs
    from repro_torch.resilience import FaultPlan, FaultSpec, faults
    from repro_torch.selection import SweepInterrupted
    log(f"[gridsweep] on {smi}")
    cfg = GRID_SWEEP
    dense_names = ("fused_xa_xtb", "mu_update_a")
    bcsr_names = ("bcsr_xa_xta", "mu_update_a")
    torch.cuda.empty_cache()
    grid = make_grid(data=1, model=1, device=dev)
    tracer = obs.Tracer(None)
    prev = obs.install(tracer)
    try:
        # (a) dense: per k, its checkpointed stop and resume, cross-k
        X, _, _ = synthetic_rescal(cfg["n"], cfg["m"], cfg["k_true"],
                                   seed=cfg["seed"], noise=cfg["noise"],
                                   device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        plan = FaultPlan()          # empty: counts the dispatch probes
        with faults.active(plan):
            perk, rep_perk, _, ms_perk = grid_sweep(
                "(a) dense per k", grid, X, cfg, launches_of=dense_names)
        n_units = len(rep_perk.units)
        hits = plan.hits.get("kernel/dispatch", 0)
        require(hits % n_units == 0 and hits > 0,
                f"{hits} dispatches over {n_units} units")
        ck = tmp / "gridsweep_dense"
        try:
            grid_sweep("(a) dense per k, stopped", grid, X, cfg,
                       ckpt_dir=str(ck), stop_after_units=2)
            raise PhaseError("stop_after_units=2 did not stop the sweep")
        except SweepInterrupted as e:
            log(f"[gridsweep] (a) {e}")
        resumed, rep_res, _, _ = grid_sweep(
            "(a) dense per k, resumed", grid, X, cfg, ckpt_dir=str(ck))
        require(rep_res.n_reused == 2, f"the resume reused "
                                       f"{rep_res.n_reused} units, want 2")
        same_result("(a) resumed against uninterrupted", resumed, perk)
        ckpt_table("(a)", tracer, ck, rep_res)
        ck_grid = tmp / "gridsweep_dense_grid"
        cross, rep_cross, _, ms_cross = grid_sweep(
            "(a) dense cross-k", grid, X, cfg, launches_of=dense_names,
            mode="grid", grid_chunk=cfg["grid_chunk"],
            ckpt_dir=str(ck_grid))
        close_curves("(a) cross-k against per k", cross, perk)
        check_masked("(a) dense cross-k", ck_grid, rep_cross.units)
        log(f"[gridsweep] (a) per MU iteration: per k {ms_perk:.3f} ms, "
            f"cross-k {ms_cross:.3f} ms (each chunk pays k_max = "
            f"{cfg['k_max']} columns in every cell); phase 6 "
            f"{MS_PER_ITER.get('phase 6', float('nan')):.3f} ms; on {smi}")

        # (c) faults on the grid: a transient unit fault on the first
        # unit, a refused kernel call in the middle of the second
        per_unit = hits // n_units
        plan = FaultPlan({
            "sched/unit": [FaultSpec(kind="raise-transient", at=(0,))],
            "kernel/dispatch": [FaultSpec(kind="budget-overflow",
                                          at=(per_unit + per_unit // 2,))]})
        n0 = len(tracer.events)
        with faults.active(plan):
            faulted, rep_f, launches_f, _ = grid_sweep(
                "(c) dense per k, faults", grid, X, cfg)
        same_result("(c) faulted against fault-free", faulted, perk)
        attempts = [u.attempts for u in rep_f.units]
        require(attempts == [2, 2] + [1] * (n_units - 2),
                f"(c) attempts {attempts}")
        chosen = [e["args"]["chosen"] for e in tracer.events[n0:]
                  if e.get("name") == "kernel/fallback"]
        require(chosen == ["retry"], f"(c) kernel/fallback events {chosen}")
        require(rep_f.meta["n_kernel_fallbacks"] == 1,
                f"(c) n_kernel_fallbacks {rep_f.meta['n_kernel_fallbacks']}")
        require(launches_f["fused_xa_xtb"] >= n_units * cfg["iters"],
                f"(c) launches {launches_f}")
        log(f"[gridsweep] (c) report identical to the fault-free one; "
            f"attempts {attempts}; the refused call counted once "
            f"(chosen=retry), no plain version ran")
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"[gridsweep] (a, c) device peak {peak / 1e9:.2f} GB")
        del X
        torch.cuda.empty_cache()

        # (b) BCSR: per k, cross-k, its checkpointed stop and resume
        spec = VirtualSpec.parse(VIRTUAL["spec"])
        sharded = virtual_sharded_bcsr(spec, device=dev)
        cell = sharded.cell(0, 0)
        torch.cuda.reset_peak_memory_stats(dev)
        bperk, _, launches_b, ms_bperk = grid_sweep(
            "(b) bcsr per k", grid, cell, cfg, launches_of=bcsr_names)
        bcross, rep_bc, launches_bc, ms_bcross = grid_sweep(
            "(b) bcsr cross-k", grid, cell, cfg, launches_of=bcsr_names,
            mode="grid", grid_chunk=cfg["grid_chunk"])
        for tag, launched in (("per k", launches_b),
                              ("cross-k", launches_bc)):
            require(launched["bcsr_spmm"] > 0,
                    f"(b) {tag}: bcsr_spmm was not launched")
        close_curves("(b) cross-k against per k", bcross, bperk)
        ck_b = tmp / "gridsweep_bcsr"
        try:
            grid_sweep("(b) bcsr cross-k, stopped", grid, cell, cfg,
                       mode="grid", grid_chunk=cfg["grid_chunk"],
                       ckpt_dir=str(ck_b), stop_after_units=1)
            raise PhaseError("stop_after_units=1 did not stop the sweep")
        except SweepInterrupted as e:
            log(f"[gridsweep] (b) {e}")
        bres, rep_bres, _, _ = grid_sweep(
            "(b) bcsr cross-k, resumed", grid, cell, cfg, mode="grid",
            grid_chunk=cfg["grid_chunk"], ckpt_dir=str(ck_b))
        require(rep_bres.n_reused == 1, f"(b) the resume reused "
                                        f"{rep_bres.n_reused} chunks")
        same_result("(b) resumed against uninterrupted", bres, bcross)
        check_masked("(b) bcsr cross-k", ck_b, rep_bres.units)
        ckpt_table("(b)", tracer, ck_b, rep_bres)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"[gridsweep] (b) per MU iteration: per k {ms_bperk:.3f} ms, "
            f"cross-k {ms_bcross:.3f} ms; phase 10 (b) "
            f"{MS_PER_ITER.get('phase 10 (b)', float('nan')):.3f} ms; "
            f"device peak {peak / 1e9:.2f} GB; on {smi}")
        del cell, sharded
    finally:
        obs.install(prev)
        grid.destroy()
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# Phase 13: LM training
# ---------------------------------------------------------------------------

def train_stats(history, cfg, batch: int, seq: int) -> dict:
    """ms per step after the first, tokens/s and the model-FLOPs share of
    the bf16 peak from a loop's history."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.models.model import model_flops
    later = [h["seconds"] for h in history[1:]]
    ms = 1e3 * sum(later) / len(later)
    flops = model_flops(cfg, ShapeSpec("train", "train", seq, batch))
    return {"ms": ms, "first_ms": 1e3 * history[0]["seconds"],
            "tok_s": batch * seq / (ms / 1e3), "tflops": flops / ms / 1e9,
            "share": flops / (ms / 1e3) / PEAK_BF16_FLOP_PER_S}


def require_finite_falling(tag: str, history) -> tuple[float, float]:
    import math
    for h in history:
        require(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
                f"{tag}: step {h['step']} loss {h['loss']} grad_norm "
                f"{h['grad_norm']}")
    first = sum(h["loss"] for h in history[:4]) / 4
    last = sum(h["loss"] for h in history[-4:]) / 4
    require(last < first, f"{tag}: mean loss of the last 4 steps {last:.4f}"
                          f" is not below the first 4's {first:.4f}")
    return first, last


def no_launches(tag: str, launches: dict) -> None:
    require(not any(launches.values()),
            f"{tag}: the train path launched kernels {launches} (it runs "
            f"the plain chunked attention; flash_attention has no backward)")


def profile_train_step(cfg, dev) -> None:
    """One full-width train step under torch.profiler (device busy time,
    idle share, time by kernel class and the top kernels), then the
    step's parts alone with CUDA events: one layer's chunked attention
    forward and forward + backward, the CE forward + backward on the
    step's logits shape, and clip + AdamW on the state."""
    import torch
    from repro_torch.data import TokenStreamConfig, batch_at
    from repro_torch.models.attention import _chunked
    from repro_torch.models.model import cross_entropy
    from repro_torch.optim import AdamW, clip_by_global_norm
    from repro_torch.train import init_state, make_train_step
    B, S = TRAIN["batch"], TRAIN["seq"]
    opt = AdamW(lr=TRAIN["lr"])
    state = init_state(cfg, opt, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    step = make_train_step(cfg, optimizer=opt, remat=True)
    batch = batch_at(TokenStreamConfig(vocab=cfg.vocab, batch=B, seq=S), 0)
    state, _ = step(state, batch)                       # warm-up
    out = {}
    wall, busy, events = profiled(lambda: out.update(
        zip(("state", "m"), step(state, batch))), host=False)
    require(busy > 0, "the profiled train step shows no device time")
    del state
    # cuBLAS's tensor-core GEMMs on Hopper are "nvjet" kernels; with
    # TF32 off the fp32 ones (the chunked attention's einsums) are SIMT
    classes = {"GEMM bf16": 0.0, "GEMM fp32": 0.0, "other": 0.0}
    for e in events:
        key = e.key.lower()
        gemm = any(w in key for w in ("gemm", "xmma", "cutlass", "nvjet"))
        cls = ("other" if not gemm else "GEMM fp32"
               if any(w in key for w in ("sgemm", "f32f32")) else
               "GEMM bf16")
        classes[cls] += e.device_time_total / 1e6
    ms_step = cuda_ms(lambda: out.update(zip(("state", "m"), step(
        out.pop("state"), batch))), reps=1, warmup=0)
    log(f"[train] profiled step: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms ({100 * (1 - busy / wall):.1f}% idle under "
        f"the profiler); unprofiled step {ms_step:.1f} ms, so "
        f"{100 * (1 - busy * 1e3 / ms_step):.1f}% idle; by class: "
        + ", ".join(f"{k} {v * 1e3:.1f} ms ({100 * v / busy:.1f}%)"
                    for k, v in classes.items()))
    for e in events[:10]:
        log(f"[train]   {e.device_time_total / 1e3:9.3f} ms "
            f"{100 * e.device_time_total / 1e6 / busy:5.1f}%  x{e.count:<6d} "
            f"{e.key[:70]}")

    state = out.pop("state")
    names, params = zip(*state.params.named_parameters())
    grads = {n: torch.randn_like(p) * 1e-3 for n, p in zip(names, params)}

    def optimizer_step():
        clipped, _ = clip_by_global_norm(grads, 1.0)
        with torch.no_grad():
            updates, _ = opt.update(clipped, state.opt, dict(zip(names,
                                                                 params)))
            for n, p in zip(names, params):
                p.add_(updates.pop(n))

    ms_opt = cuda_ms(optimizer_step, reps=3, warmup=1)
    del grads, state
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(1)
    hd = cfg.head_dim
    q = torch.randn(B, S, cfg.n_heads, hd, device=dev, generator=gen,
                    dtype=torch.bfloat16).requires_grad_()
    k, v = (torch.randn(B, S, cfg.n_kv, hd, device=dev, generator=gen,
                        dtype=torch.bfloat16).requires_grad_()
            for _ in range(2))
    kw = dict(causal=True, q_offset=0, chunk=1024, q_chunk=256,
              sm_scale=None)

    def attn_fwd():
        with torch.no_grad():
            _chunked(q, k, v, **kw)

    def attn_fwd_bwd():
        o = _chunked(q, k, v, **kw)
        torch.autograd.grad(o, (q, k, v), torch.ones_like(o))

    ms_af = cuda_ms(attn_fwd, reps=3, warmup=1)
    ms_afb = cuda_ms(attn_fwd_bwd, reps=3, warmup=1)
    del q, k, v
    torch.cuda.empty_cache()
    logits = torch.randn(B, S, cfg.padded_vocab, device=dev, generator=gen,
                         dtype=torch.bfloat16).requires_grad_()
    labels = torch.randint(0, cfg.vocab, (B, S), device=dev, generator=gen)

    def ce_fwd_bwd():
        loss, _ = cross_entropy(logits, labels, cfg.vocab)
        torch.autograd.grad(loss, logits)

    ms_ce = cuda_ms(ce_fwd_bwd, reps=3, warmup=1)
    del logits
    torch.cuda.empty_cache()
    attn_step = cfg.n_layers * (ms_af + ms_afb)     # remat: 2 fwd + 1 bwd
    log(f"[train] parts alone (CUDA events): chunked attention per layer "
        f"fwd {ms_af:.2f} ms, fwd+bwd {ms_afb:.2f} ms -> {attn_step:.1f} ms "
        f"per step with remat ({100 * attn_step / ms_step:.1f}% of the "
        f"unprofiled step); CE fwd+bwd {ms_ce:.2f} ms "
        f"({100 * ms_ce / ms_step:.1f}%); clip + AdamW {ms_opt:.2f} ms "
        f"({100 * ms_opt / ms_step:.1f}%)")


def load_example(name: str):
    import importlib.util
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_train(tmp: Path, dev, smi: str) -> None:
    """Phase 13 (see the module docstring)."""
    import torch
    from repro_torch import ckpt
    from repro_torch.configs import ARCHS
    from repro_torch.core.rescalk import default_member_runner, rescalk
    from repro_torch.data import TokenStreamConfig, batch_at, trade_like
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model import count_params_analytic
    from repro_torch.obs import trace as obs
    from repro_torch.optim import AdamW
    from repro_torch.resilience import FaultPlan, FaultSpec, faults
    from repro_torch.selection import RescalkConfig
    from repro_torch.train import (LoopConfig, init_state, make_train_step,
                                   train_loop)
    cfg = ARCHS[TRAIN["arch"]]
    B, S = TRAIN["batch"], TRAIN["seq"]
    n_params = count_params_analytic(cfg)["total"]
    log(f"[train] on {smi}; {cfg.name}: {n_params / 1e9:.3f} G params, "
        f"batch {B} x seq {S} (train_4k's 256 cut to {B}), --remat; "
        f"{shutil.disk_usage(tmp).free / 1e9:.0f} GB free on disk")

    # (a) the CLI, under deterministic algorithms: its first steps are
    # (b)'s uninterrupted run (the same stream, seed, lr and remat)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        hist = train_cli.main(["--arch", TRAIN["arch"], "--steps",
                               str(TRAIN["steps"]), "--batch", str(B),
                               "--seq", str(S), "--lr", str(TRAIN["lr"]),
                               "--remat", "--device", "cuda"])
    finally:
        torch.use_deterministic_algorithms(False)
    wall = time.perf_counter() - t0
    no_launches("(a)", ops.launch_counts())
    peak = torch.cuda.max_memory_allocated(dev)
    require(len(hist) == TRAIN["steps"], f"(a) {len(hist)} steps recorded")
    first, last = require_finite_falling("(a)", hist)
    MEASURED_PEAKS["llama3.2-1b train"] = peak
    st = train_stats(hist, cfg, B, S)
    log(f"[train] (a) losses " + " ".join(f"{h['loss']:.4f}" for h in hist)
        + "; grad_norm " + " ".join(f"{h['grad_norm']:.3f}" for h in hist))
    log(f"[train] (a) mean loss first 4 {first:.4f} -> last 4 {last:.4f}; "
        f"{st['ms']:.1f} ms per step after the first (first "
        f"{st['first_ms']:.1f}), {st['tok_s']:.0f} tokens/s, model FLOPs "
        f"{st['tflops']:.1f} TFLOP/s = {100 * st['share']:.2f}% of the "
        f"989 TFLOP/s bf16 dense peak; peak device memory {peak / 1e9:.2f} "
        f"GB; {wall:.1f}s wall (deterministic algorithms); 0 kernel "
        f"launches; on {smi}")
    torch.cuda.empty_cache()

    # (c) microbatches, and (d) the guard, on one fresh state each
    ds = TokenStreamConfig(vocab=cfg.vocab, batch=B, seq=S)
    batch = batch_at(ds, 0)
    got = {}
    t0 = time.perf_counter()
    for mb in (1, TRAIN["microbatches"]):
        opt = AdamW(lr=TRAIN["lr"])
        state = init_state(cfg, opt, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = make_train_step(cfg, optimizer=opt, remat=True,
                                   microbatches=mb)(state, batch)
        got[mb] = {k: float(v) for k, v in m.items()}
        got[mb]["seconds"] = time.perf_counter() - t0
        no_launches(f"(c) microbatches={mb}", ops.launch_counts())
        if mb > 1:
            try:
                state.params(batch["tokens"][:1, :256].to(dev), impl="cuda")
            except RuntimeError as err:
                require("no backward" in str(err), f"(d) {err}")
            else:
                require(False, "(d) a forward with impl='cuda' under grad "
                               "did not raise")
        del state, opt
        torch.cuda.empty_cache()
    one, two = got[1], got[TRAIN["microbatches"]]
    for key in ("loss", "grad_norm"):
        rel = abs(two[key] - one[key]) / abs(one[key])
        require(rel <= TRAIN_MB_TOL, f"(c) {key}: {two[key]} with "
                f"microbatches against {one[key]} ({rel:.2e} relative)")
    log(f"[train] (c) microbatches=2 loss {two['loss']:.5f} grad_norm "
        f"{two['grad_norm']:.5f} against one batch {one['loss']:.5f} / "
        f"{one['grad_norm']:.5f} (within {TRAIN_MB_TOL}); "
        f"{1e3 * two['seconds']:.1f} ms against {1e3 * one['seconds']:.1f}"
        f" (first steps); {time.perf_counter() - t0:.1f}s wall")
    log("[train] (d) a forward with impl='cuda' under grad raised "
        "RuntimeError; (a)-(c) launched no flash_attention")

    # (b) restart identity under deterministic algorithms, against (a)
    fn = lambda s: batch_at(ds, s)                       # noqa: E731
    n = TRAIN["restart_steps"]
    clean = hist[:n]
    ck = tmp / "train_ck"
    plan = FaultPlan({"train/step": [FaultSpec(
        kind="raise-transient", at=(TRAIN["fault_hit"],))]})
    tracer = obs.Tracer(None)
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        prev = obs.install(tracer)
        try:
            with faults.active(plan):
                state, faulty = train_loop(
                    cfg, fn, LoopConfig(steps=n, seed=0, ckpt_dir=str(ck),
                                        save_every=TRAIN["save_every"]),
                    optimizer=AdamW(lr=TRAIN["lr"]), remat=True, device=dev)
            del state
        finally:
            obs.install(prev)
        no_launches("(b)", ops.launch_counts())
    finally:
        torch.use_deterministic_algorithms(False)
    peak_b = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    require([f["hit"] for f in plan.fired] == [TRAIN["fault_hit"]],
            f"(b) fired {plan.fired}")
    replay = TRAIN["save_every"]
    want_steps = (list(range(TRAIN["fault_hit"])) +
                  list(range(replay, n)))
    require([h["step"] for h in faulty] == want_steps,
            f"(b) steps {[h['step'] for h in faulty]}, want {want_steps}")
    clean_loss = {h["step"]: h["loss"] for h in clean}
    for h in faulty:
        require(h["loss"] == clean_loss[h["step"]],
                f"(b) step {h['step']}: loss {h['loss']!r} against the "
                f"uninterrupted run's {clean_loss[h['step']]!r}")
    spans = {}
    for e in tracer.events:
        if e.get("ph") == "E" and e["name"] in ("train/save",
                                                 "train/restore"):
            spans.setdefault(e["name"], []).append(e["dur"] / 1e6)
    nbytes = {p.name: p.stat().st_size for p in sorted(ck.glob("*.npz"))}
    require(ckpt.latest_step(str(ck)) == n, f"(b) LATEST is "
            f"{ckpt.latest_step(str(ck))}")
    log(f"[train] (b) restart under torch.use_deterministic_algorithms("
        f"True): fault at hit {TRAIN['fault_hit']}, restored step {replay}, "
        f"steps {[h['step'] for h in faulty]}: every loss equals the "
        f"uninterrupted run's ((a)'s) bit for bit; checkpoints "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in nbytes.items())
        + "; save s " + ", ".join(f"{x:.2f}" for x in spans.get(
            "train/save", []))
        + "; restore s " + ", ".join(f"{x:.2f}" for x in spans.get(
            "train/restore", []))
        + f"; {train_stats(faulty, cfg, B, S)['ms']:.1f} ms per step; peak "
        f"device memory {peak_b / 1e9:.2f} GB; {time.perf_counter() - t0:.1f}"
        f"s wall; on {smi}")
    shutil.rmtree(ck)

    # where a step's time goes
    t0 = time.perf_counter()
    profile_train_step(cfg, dev)
    log(f"[train] profile: {time.perf_counter() - t0:.1f}s wall")

    # (e) the examples and the custom-runner loop
    for name in ("torch_trade_nations", "torch_quickstart"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        k_opt = load_example(name).main(["--device", "cuda"])
        launches = ops.launch_counts()
        for kernel in ("fused_xa_xtb", "mu_update_a"):
            require(launches[kernel] > 0, f"(e) {name}: {kernel} was not "
                                          f"launched")
        log(f"[train] (e) examples/{name}.py --device cuda: k_opt "
            f"{k_opt}, {time.perf_counter() - t0:.1f}s, launches "
            f"{launches}")
    X, _, _ = trade_like(n=TRADE["n"], m=TRADE["m"], k=TRADE["k"],
                         seed=TRADE["seed"], device=dev)
    tcfg = RescalkConfig(k_min=TRADE["k_min"], k_max=TRADE["k_max"],
                         n_perturbations=TRADE["r"],
                         rescal_iters=TRADE["iters"],
                         regress_iters=TRADE["regress_iters"], seed=0,
                         kernel=KernelPolicy(use_fused=True))
    calls = []

    def runner(X_q, k, generator, cfg, init=None):
        calls.append(k)
        return default_member_runner(X_q, k, generator, cfg, init=init)

    ops.reset_launch_counts()
    custom = rescalk(X, tcfg, member_runner=runner)
    launches = ops.launch_counts()
    loop = rescalk(X, tcfg, mode="loop")
    n_members = (TRADE["k_max"] - TRADE["k_min"] + 1) * TRADE["r"]
    want = n_members * TRADE["iters"]
    require(len(calls) == n_members, f"(e) runner called {len(calls)}")
    for kernel in ("fused_xa_xtb", "mu_update_a"):
        require(launches[kernel] == want, f"(e) custom runner: {kernel} "
                f"launched {launches[kernel]} times, want {want}")
    require(custom.k_opt == loop.k_opt, f"(e) custom runner k_opt "
            f"{custom.k_opt}, loop mode {loop.k_opt}")
    close_curves("(e) custom runner vs loop mode", custom, loop)
    same = all((getattr(custom, f) == getattr(loop, f)).all()
               for f in ("s_min", "s_mean", "rel_err"))
    log(f"[train] (e) rescalk(member_runner=...) on the trade tensor: "
        f"k_opt {custom.k_opt} (loop mode {loop.k_opt}), per-k "
        f"{'bit-identical to' if same else 'within 1e-4 of'} loop mode; "
        f"launches {launches}")


# ---------------------------------------------------------------------------
# Phase 14: the LM zoo's other families at their published widths
# ---------------------------------------------------------------------------

def check_zoo_flash(dev) -> None:
    """flash_attention at the zoo's two call shapes beyond the dense
    decoders', inputs written as the models write them and passed as
    permuted (B, S, H, D) views (no copies): the kernel against its plain
    version on the same inputs (relative Frobenius error within
    ZOO_TOL), the padded output columns exactly 0; both timed with CUDA
    events beside the plain version, one scaled_dot_product_attention
    call on the unpadded tensors (checked within ZOO_TOL too), and the
    bound of the function's own widths (``flash_attention.cost``), the
    padded widths' bound printed beside as the padding's cost."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    for case in ZOO_FLASH:
        b, h, sq, skv, d = (case[k] for k in ("b", "h", "sq", "skv", "d"))
        dqk, dv, causal = case["dqk"], case["dv"], case["causal"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(sq + skv)
        q, k, v = (torch.zeros((b, s, h, d), dtype=torch.bfloat16,
                               device=dev) for s in (sq, skv, skv))
        for x, cols in ((q, dqk), (k, dqk), (v, dv)):
            x[..., :cols] = torch.randn(x[..., :cols].shape, generator=gen,
                                        device=dev)
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        kw = dict(causal=causal, sm_scale=dqk ** -0.5)
        tag = (f"{case['name']}: b={b} h={h} sq={sq} skv={skv} d={d} "
               f"({dqk}/{dv}) bf16 {'causal' if causal else 'non-causal'}")
        fa.reset_launch_count()
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        require(fa.launch_count_by_variant() == {"sm90_bf16": 1,
                                                 "fma_fp32": 0},
                f"flash_attention [{tag}]: {fa.launch_count_by_variant()}")
        plain = ref.ref_attention(q, k, v, **kw)
        err = rel_frob(got, plain)
        require(err <= ZOO_TOL, f"flash_attention [{tag}]: {err:.3e} from "
                f"the plain version (> {ZOO_TOL})")
        require(not bool(got[..., dv:].any()),
                f"flash_attention [{tag}]: padded output columns not 0")
        qu, ku, vu = (x[..., :cols].contiguous()
                      for x, cols in ((q, dqk), (k, dqk), (v, dv)))
        lib_fn = sdpa_call(qu, ku, vu, causal=causal, scale=dqk ** -0.5)
        lib_err = rel_frob(lib_fn(), plain[..., :dv])
        require(lib_err <= ZOO_TOL, f"scaled_dot_product_attention [{tag}]"
                f" (yardstick): {lib_err:.3e} from the plain version")
        del got, plain
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=10)
        plain_ms = cuda_ms(lambda: ref.ref_attention(q, k, v, **kw), reps=2,
                           warmup=1)
        lib_ms = cuda_ms(lib_fn, reps=10)
        bound_, by = bound(fa.cost(q, k, v, causal=causal, dqk=dqk, dv=dv),
                           PEAK_BF16_FLOP_PER_S)
        padded, _ = bound(fa.cost(q, k, v, causal=causal),
                          PEAK_BF16_FLOP_PER_S)
        log(f"[zoo] flash_attention [{tag}]: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, scaled_dot_product_attention on the "
            f"unpadded tensors {lib_ms:.3f} ms ({ms / lib_ms:.2f}x; relative "
            f"error {lib_err:.3e}), bound {bound_:.4f} ms ({by}, the "
            f"function's {dqk}/{dv} widths; {100 * bound_ / ms:.1f}%), "
            f"{padded:.4f} ms at the padded {d}/{d} (the padding's cost "
            f"{padded / bound_:.2f}x), relative error {err:.3e}")
        del q, k, v, qu, ku, vu, lib_fn
        torch.cuda.empty_cache()


def zoo_flash_want(cfg) -> int:
    """flash_attention launches of one prefill: one per GQA or MLA layer;
    enc-dec adds its encoder's and one cross attention per decoder
    layer; the SSM and the hybrid's sliding window launch none."""
    if cfg.family in ("ssm", "hybrid"):
        return 0
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def check_zoo_run(res, tag: str, smi: str, tape: RouteTape) -> None:
    """One served run of phase 14 (the counters zeroed before it, its
    routing recorded by ``tape``): the prefill's flash_attention
    launches, all on the tensor-core kernel, and no other kernel; valid
    tokens and finite logits; then the plain path (``demo_vs_plain``)
    within ZOO_TOL: as it routes itself for a model without experts, on
    the run's own expert choices for an MoE model, whose own-routing
    error and flipped share must also be within ZOO_FREE_SLACK of a
    kernel-free bf16 path's.  Prints the cell's lines."""
    import torch
    from repro_torch.kernels import ops
    cfg = res.model.cfg
    want = zoo_flash_want(cfg)
    launches = ops.launch_counts()
    require(launches["flash_attention"] == want == res.flash_launches,
            f"{tag}: flash_attention launched {launches['flash_attention']}"
            f" times in the run, {res.flash_launches} in the prefill; want "
            f"{want}")
    require(res.flash_by_variant == {"sm90_bf16": want, "fma_fp32": 0},
            f"{tag}: {res.flash_by_variant}, want {want} sm90_bf16")
    require(not any(n for name, n in launches.items()
                    if name != "flash_attention"),
            f"{tag}: other kernels launched: {launches}")
    B, T = res.tokens.shape[0], res.tokens.shape[1] - 1
    require(int(res.tokens.max()) < cfg.vocab
            and int(res.tokens.min()) >= 0, f"{tag}: bad tokens")
    require(bool(torch.isfinite(res.prefill_logits).all())
            and bool(torch.isfinite(res.step_logits).all()),
            f"{tag}: non-finite logits")
    got = demo_vs_plain(res, tag, tape)
    key = "forced" if "forced" in got else "free"
    pre_err, step_err, same = got[key]
    require(pre_err <= ZOO_TOL, f"{tag}: last-position logits {pre_err:.3e} "
            f"from the plain path ({key} routing; > {ZOO_TOL})")
    require(step_err <= ZOO_TOL, f"{tag}: step logits {step_err:.3e} from "
            f"the plain path ({key} routing; > {ZOO_TOL})")
    Pn = res.prompts.shape[1]
    log(f"[zoo] {tag} ({smi}): prefill {B}x{res.start} "
        f"{res.prefill_ms:.1f} ms ({B * Pn / res.prefill_ms * 1e3:.0f} "
        f"tok/s); decode {T} steps {res.decode_ms / T:.2f} ms/step "
        f"({B * T / res.decode_ms * 1e3:.0f} tok/s); peak device memory "
        f"{res.peak_bytes / 1e9:.2f} GB; flash_attention launches "
        f"{res.flash_by_variant}")
    log(f"[zoo] {tag} kernel vs plain path ({key} routing): last-position "
        f"logits {pre_err:.3e}, decode logits fed the kernel path's tokens "
        f"{step_err:.3e} at most, greedy tokens equal in {same} of {B * T}")
    if key == "free":
        return
    mean = statistics.fmean
    shares = {"kernel": got["free"] + (mean(got["flipped"]),),
              "scaled_dot_product_attention": got["sdpa"]
              + (mean(got["flipped_sdpa"]),)}
    for name, (fp, fs, fsame, flip) in shares.items():
        log(f"[zoo] {tag} {name} path on its own routing against the "
            f"plain path's: last-position logits {fp:.3e}, steps {fs:.3e} "
            f"at most, greedy tokens equal in {fsame} of {B * T}; "
            f"top-{cfg.top_k} expert sets that differ in the prefill "
            f"{100 * flip:.2f}% of the (token, layer) pairs")
    (kp, *_, kf), (sp, *_, sf) = shares.values()
    require(kp <= ZOO_FREE_SLACK * sp and kf <= ZOO_FREE_SLACK * sf,
            f"{tag}: on its own routing the kernel path is {kp:.3e} from "
            f"the plain path with {100 * kf:.2f}% flipped, over "
            f"{ZOO_FREE_SLACK}x the kernel-free path's {sp:.3e} and "
            f"{100 * sf:.2f}%")
    pct = " ".join(f"{100 * f:.1f}" for f in got["flipped"])
    log(f"[zoo] {tag} flipped per MoE layer, kernel path (%): {pct}")
    pct = " ".join(f"{100 * f:.1f}" for f in got["flipped_sdpa"])
    log(f"[zoo] {tag} flipped per MoE layer, kernel-free path (%): {pct}")
    m_all, m_flip, n_flip = got["margin0"]
    log(f"[zoo] {tag} first MoE layer: the plain path's k-th probability "
        f"leads the (k+1)-th by {m_all:.3e} (median over tokens), by "
        f"{'-' if m_flip is None else f'{m_flip:.3e}'} over the "
        f"{n_flip} tokens whose set the kernel path flips there")
    dropped = sum(d for d, _ in got["dropped"])
    assigned = sum(n for _, n in got["dropped"])
    pct = " ".join(f"{100 * d / n:.1f}" for d, n in got["dropped"])
    log(f"[zoo] {tag} assignments dropped past capacity in the prefill: "
        f"{dropped} of {assigned} ({100 * dropped / assigned:.3f}%); per MoE"
        f" layer (%): {pct}")
    ratio = " ".join(f"{b:.2f}" for b in got["busiest"])
    log(f"[zoo] {tag} busiest expert's load per group over the capacity, "
        f"mean over groups, per MoE layer: {ratio}")


def phase_zoo(dev, smi: str) -> None:
    """Phase 14 (see the module docstring)."""
    import gc

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import decode_demo
    from repro_torch.models.transformer import Transformer
    log(f"[zoo] {smi}")
    check_zoo_flash(dev)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def demo(arch: str, batch: int, prompt: int, new_tokens: int):
        """A warm-up through decode_demo at the cell's own batch and
        prompt (2 tokens, unchecked, its model freed), then the timed
        run with the counters zeroed just before and its routing
        recorded: (result, tape)."""
        shape = ("--batch", str(batch), "--prompt-len", str(prompt))
        run_demo(arch, *shape, "--new-tokens", "2")
        free()
        ops.reset_launch_counts()
        with RouteTape() as tape:
            res = run_demo(arch, *shape, "--new-tokens", str(new_tokens))
        return res, tape

    # (a) deepseek-moe-16b at full width through decode_demo
    a = ZOO_SERVE
    res, tape = demo(a["arch"], a["batch"], a["prompt"], a["new_tokens"])
    n = sum(p.numel() for p in res.model.parameters())
    log(f"[zoo] {a['arch']}: {n / 1e9:.3f}B parameters, "
        f"{2 * n / 1e9:.2f} GB in bf16")
    check_zoo_run(res, a["arch"], smi, tape)
    MEASURED_PEAKS[f"{a['arch']} serve"] = res.peak_bytes
    profile_lm(res, min(ZOO_PROFILE_STEPS, a["new_tokens"]), top=14,
               tag="zoo")
    del res, tape
    free()

    # (b) the other families at their published widths
    for arch in ZOO_DEMOS:
        res, tape = demo(arch, ZOO_DEMO["batch"], ZOO_DEMO["prompt"],
                         ZOO_DEMO["new_tokens"])
        check_zoo_run(res, arch, smi, tape)
        del res, tape
        free()
    for arch, shape in ZOO_LIBRARY.items():
        cfg = ARCHS[arch]
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = Transformer(cfg, device=dev, gen=gen)
        gen.manual_seed(1)
        B = shape["batch"]
        prompts = torch.randint(0, cfg.vocab, (B, shape["tokens"]),
                                generator=gen, device=dev)
        n_in = shape.get("frames") or cfg.n_patches
        x = torch.randn((B, n_in, cfg.d_model), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        inputs = {"frames" if cfg.family == "encdec" else "patches": x}
        log(f"[zoo] {arch} through decode_demo.serve: {B} x "
            f"{shape['tokens']} tokens after {n_in} "
            f"{'frames' if cfg.family == 'encdec' else 'patches'} (after a "
            f"warm-up of 2 tokens, unchecked)")
        decode_demo.serve(model, prompts, 2, **inputs)
        free()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        with RouteTape() as tape:
            res = decode_demo.serve(model, prompts, ZOO_DEMO["new_tokens"],
                                    **inputs)
        check_zoo_run(res, arch, smi, tape)
        del res, model, inputs, x, tape
        free()


# ---------------------------------------------------------------------------
# Phase 15: the LM on the process grid
# ---------------------------------------------------------------------------

def seeded_llama(arch: str, batch: int, prompt: int, dev):
    """decode_demo.run's model and prompts: weights from seed 0, prompts
    from seed 1, on ``dev``."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models.transformer import Transformer
    cfg = ARCHS[arch]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Transformer(cfg, device=dev, gen=gen)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                            device=dev)
    return model, prompts


def forced_single(model, prompts, tokens):
    """The single-device path on ``model`` (whole parameters) fed
    ``tokens`` (B, T + 1): (last-position logits, [each step's
    logits])."""
    import torch
    from repro_torch.train import make_prefill_step, make_serve_step
    logits, filled = make_prefill_step(model)(prompts)
    P, T = prompts.shape[1], tokens.shape[1] - 1
    with torch.inference_mode():
        cache = model.extend_cache(filled, P + T)
    del filled
    serve = make_serve_step(model)
    steps = []
    for t in range(T):
        step, cache = serve(cache, tokens[:, t:t + 1], P + t)
        steps.append(step)
    return logits, steps


def grid_serve_counts(model, grid, prompts) -> tuple[int, int]:
    """The collectives of one grid prefill of ``prompts`` and of one
    decode step after it (run before the timed serve: its warm-up)."""
    from repro_torch.models.model import greedy_sample
    from repro_torch.train import make_prefill_step, make_serve_step
    c0 = grid.collectives
    logits, cache = make_prefill_step(model, grid=grid,
                                      max_len=prompts.shape[1] + 1)(prompts)
    c1 = grid.collectives
    make_serve_step(model, grid=grid)(
        cache, greedy_sample(logits, model.cfg.vocab), prompts.shape[1])
    return c1 - c0, grid.collectives - c1


def lm_grid_serve(grid, dev, smi: str) -> None:
    """Phase 15 (a), serving (see the module docstring)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import decode_demo
    from repro_torch.train.serve_step import params_shardings
    g = GRID_LM
    B, P, T = g["batch"], g["prompt"], g["new_tokens"]
    model, prompts = seeded_llama(g["arch"], B, P, dev)
    cfg = model.cfg
    params_shardings(grid, model)
    pre_c, step_c = grid_serve_counts(model, grid, prompts[:, :256])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = decode_demo.serve(model, prompts, T, grid=grid)
    launches = ops.launch_counts()
    by_variant = fa.launch_count_by_variant()
    require(launches["flash_attention"] == cfg.n_layers
            and not any(n for k, n in launches.items()
                        if k != "flash_attention"),
            f"(a) the grid serve launched {launches}, want "
            f"{cfg.n_layers} flash_attention and nothing else")
    require(by_variant == {"sm90_bf16": cfg.n_layers, "fma_fp32": 0},
            f"(a) the grid prefill launched {by_variant}")
    require(bool(torch.isfinite(res.prefill_logits).all())
            and bool(torch.isfinite(res.step_logits).all()),
            "(a) non-finite logits")
    pre, steps, same = _against(res.prefill_logits,
                                list(res.step_logits.split(1, dim=1)),
                                *forced_single(model, prompts, res.tokens),
                                cfg.vocab)
    require(pre <= GRID_ONE_TOL and steps <= GRID_ONE_TOL,
            f"(a) grid against single device: prefill {pre:.3e}, steps "
            f"{steps:.3e} (> {GRID_ONE_TOL})")
    require(same == B * T, f"(a) greedy tokens equal in {same} of {B * T}")
    log(f"[lmgrid] (a) 1 x 1 grid serve, {cfg.name} {cfg.dtype}: prefill "
        f"{B}x{P} {res.prefill_ms:.1f} ms, {launches['flash_attention']} "
        f"flash_attention launches ({by_variant}); decode {T} steps "
        f"{res.decode_ms / T:.2f} ms/step; collectives per prefill "
        f"{pre_c}, per decode step {step_c}; peak device memory "
        f"{res.peak_bytes / 1e9:.2f} GB; on {smi}")
    log(f"[lmgrid] (a) against the single-device path fed the grid's "
        f"tokens: last-position logits relative difference {pre:.3e}, "
        f"steps at most {steps:.3e}; greedy tokens equal in {same} of "
        f"{B * T}")
    del res, model
    torch.cuda.empty_cache()


def lm_grid_train(grid, dev, smi: str) -> None:
    """Phase 15 (a), training (see the module docstring)."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenStreamConfig, batch_at
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamW
    from repro_torch.train import init_state, make_train_step
    g = GRID_LM
    cfg = ARCHS[g["arch"]]
    ds = TokenStreamConfig(vocab=cfg.vocab, batch=g["train_batch"],
                           seq=g["train_seq"])
    batches = [batch_at(ds, s) for s in range(g["train_steps"])]
    opt = AdamW(lr=g["lr"])

    def run(on_grid):
        torch.cuda.reset_peak_memory_stats(dev)
        state = init_state(cfg, opt, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev,
            grid=grid if on_grid else None)
        step = make_train_step(cfg, grid=grid if on_grid else None,
                               optimizer=opt, remat=True)
        hist = []
        for b in batches:
            c0 = grid.collectives
            t0 = time.perf_counter()
            state, m = step(state, b)
            loss = float(m["loss"])
            hist.append(dict(loss=loss, grad_norm=float(m["grad_norm"]),
                             ms=1e3 * (time.perf_counter() - t0),
                             collectives=grid.collectives - c0))
        params = {n: p.detach().cpu()
                  for n, p in state.params.named_parameters()}
        peak = torch.cuda.max_memory_allocated(dev)
        del state
        torch.cuda.empty_cache()
        return hist, params, peak

    ops.reset_launch_counts()
    one, ref, peak1 = run(False)
    got, params, peak = run(True)
    no_launches("(a) grid train", ops.launch_counts())
    for a, b in zip(got, one):
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        require(math.isfinite(a["loss"]) and rel <= GRID_LOSS_TOL,
                f"(a) grid train loss {a['loss']} against {b['loss']}")
    worst = max(float((params[n].float() - ref[n].float()).abs().max())
                for n in ref)
    atol = 2 * g["lr"] * g["train_steps"]
    require(worst <= atol, f"(a) grid train parameters {worst:.3e} from "
                           f"the single-device step's (> {atol})")
    log(f"[lmgrid] (a) 1 x 1 grid train, batch {g['train_batch']} x seq "
        f"{g['train_seq']}, --remat: losses "
        + " ".join(f"{h['loss']:.5f}" for h in got) + " against "
        + " ".join(f"{h['loss']:.5f}" for h in one) + "; grad_norm "
        + " ".join(f"{h['grad_norm']:.4f}" for h in got) + " against "
        + " ".join(f"{h['grad_norm']:.4f}" for h in one)
        + f"; parameters after {g['train_steps']} steps at most "
        f"{worst:.3e} apart; ms per step " + " ".join(
            f"{h['ms']:.1f}" for h in got) + " (single device " + " ".join(
            f"{h['ms']:.1f}" for h in one) + "); collectives per step "
        + " ".join(str(h["collectives"]) for h in got)
        + f"; peak device memory {peak / 1e9:.2f} GB (single device "
        f"{peak1 / 1e9:.2f}); on {smi}")


def lm_grid_ef_psum(grid, dev) -> None:
    """Phase 15 (a): ef_psum on a CUDA tensor against its plain formula
    (on a group of one: the int8 round trip of g + err)."""
    import torch
    from repro_torch.optim import compression
    gen = torch.Generator(device=dev).manual_seed(2)
    g = torch.randn(GRID_LM["ef_shape"], generator=gen, device=dev)
    err = 1e-3 * torch.randn(GRID_LM["ef_shape"], generator=gen, device=dev)
    c0 = grid.collectives
    mean, new_err = compression.ef_psum(g, err, grid, "data")
    c, want_err = compression.ef_compress(g, err)
    require(torch.equal(mean, compression.decompress(c))
            and torch.equal(new_err, want_err),
            "(a) ef_psum on the card differs from its plain formula")
    log(f"[lmgrid] (a) ef_psum on a {tuple(g.shape)} CUDA tensor: equal to "
        f"the int8 round trip of g + err, residual equal; "
        f"{grid.collectives - c0} collectives (MAX of the scale, int32 "
        f"SUM)")


def tp_cell(grid, arch: str, batch: int, prompt: int, new: int) -> dict:
    """Phase 15 (b), one cell of the 1 x 2 grid (a spawned process on the
    card): the seeded model placed on the grid, served through
    decode_demo.serve after a warm-up; what it launched, on which heads,
    and what it returned."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import decode_demo
    from repro_torch.train.serve_step import params_shardings
    dev = grid.device
    model, prompts = seeded_llama(arch, batch, prompt, dev)
    params_shardings(grid, model)
    pre_c, step_c = grid_serve_counts(model, grid, prompts[:, :256])
    heads = []
    flash = ops.flash_attention

    def recorded(q, k, v, **kw):
        heads.append((q.shape[1], k.shape[1]))
        return flash(q, k, v, **kw)

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    ops.flash_attention = recorded
    try:
        res = decode_demo.serve(model, prompts, new, grid=grid)
    finally:
        ops.flash_attention = flash
    launches = ops.launch_counts()
    variants = fa.launch_count_by_variant()
    return {"prefill": res.prefill_logits.float().cpu(),
            "steps": res.step_logits.float().cpu(),
            "tokens": res.tokens.cpu(), "launches": launches,
            "variants": variants, "heads": heads,
            "prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms,
            "peak": res.peak_bytes, "collectives": (pre_c, step_c)}


def lm_grid_tp(tmp: Path, dev, smi: str) -> None:
    """Phase 15 (b) (see the module docstring)."""
    import torch
    from repro_torch.launch.mesh import spawn_grid
    g, t = GRID_LM, GRID_TP
    B, P, T = t["batch"], t["prompt"], t["new_tokens"]
    t0 = time.perf_counter()
    cells = spawn_grid(tp_cell, tmp / "lm_tp", data=1, model=t["model"],
                       lm=True, device="cuda",
                       args=(g["arch"], B, P, T), timeout_s=600)
    wall = time.perf_counter() - t0
    L = len(cells[0]["heads"])
    for r, c in enumerate(cells):
        require(c["launches"]["flash_attention"] == L == g["layers"]
                and c["variants"] == {"sm90_bf16": L, "fma_fp32": 0},
                f"(b) rank {r} launched {c['launches']} {c['variants']}")
        require(set(c["heads"]) == {t["heads"]},
                f"(b) rank {r} attended (query, KV) heads "
                f"{sorted(set(c['heads']))}, want {t['heads']}")
        require(torch.equal(c["tokens"], cells[0]["tokens"]),
                "(b) the two model ranks' tokens differ")
    model, prompts = seeded_llama(g["arch"], B, P, dev)
    tokens = cells[0]["tokens"].to(dev)
    pre, steps, same = _against(
        cells[0]["prefill"].to(dev),
        list(cells[0]["steps"].to(dev).split(1, dim=1)),
        *forced_single(model, prompts, tokens), model.cfg.vocab)
    del model
    torch.cuda.empty_cache()
    require(pre <= LM_BF16_TOL and steps <= LM_BF16_TOL,
            f"(b) TP = 2 against one device: prefill {pre:.3e}, steps "
            f"{steps:.3e} (> {LM_BF16_TOL})")
    require(same >= GRID_TP_SAME * B * T,
            f"(b) greedy tokens equal in {same} of {B * T}")
    c = cells[0]
    log(f"[lmgrid] (b) 1 x 2 grid (gloo on CUDA tensors, two processes on "
        f"one card): each rank {L} sm90_bf16 launches on {t['heads'][0]} "
        f"query and {t['heads'][1]} KV heads; prefill {B}x{P} "
        + " / ".join(f"{x['prefill_ms']:.1f}" for x in cells)
        + " ms, decode " + " / ".join(f"{x['decode_ms'] / T:.2f}"
                                     for x in cells)
        + f" ms/step (ranks 0 / 1); collectives per prefill "
        f"{c['collectives'][0]}, per decode step {c['collectives'][1]}; "
        f"peak device memory per rank " + " / ".join(
            f"{x['peak'] / 1e9:.2f}" for x in cells)
        + f" GB; {wall:.1f}s wall with start-up; on {smi}")
    log(f"[lmgrid] (b) against the single-device path fed the grid's "
        f"tokens: last-position logits {pre:.3e}, steps at most "
        f"{steps:.3e} (within {LM_BF16_TOL}); greedy tokens equal in "
        f"{same} of {B * T}")


def phase_lm_grid(tmp: Path, dev, smi: str) -> None:
    """Phase 15 (see the module docstring)."""
    import torch
    from repro_torch.launch.mesh import make_lm_grid
    log(f"[lmgrid] {smi}")
    t0 = time.perf_counter()
    grid = make_lm_grid(data=1, model=1)
    try:
        lm_grid_serve(grid, dev, smi)
        lm_grid_train(grid, dev, smi)
        lm_grid_ef_psum(grid, dev)
    finally:
        grid.destroy()
    torch.cuda.empty_cache()
    log(f"[lmgrid] (a) {time.perf_counter() - t0:.1f}s wall")
    lm_grid_tp(tmp, dev, smi)


# ---------------------------------------------------------------------------
# Phase 16: the LM zoo's other families on the process grid
# ---------------------------------------------------------------------------

def grid_fed(model, grid, prompts, tokens):
    """The grid path on a placed model fed ``tokens`` (B, T + 1), this
    cell's rows: (last-position logits, [each step's logits])."""
    from repro_torch.dist.sharding import shard_batch
    from repro_torch.train import make_prefill_step, make_serve_step
    P, T = prompts.shape[1], tokens.shape[1] - 1
    logits, cache = make_prefill_step(model, grid=grid, max_len=P + T)(
        prompts)
    rows = shard_batch(grid, {"t": tokens})["t"]
    serve = make_serve_step(model, grid=grid)
    steps = []
    for t in range(T):
        step, cache = serve(cache, rows[:, t:t + 1], P + t)
        steps.append(step)
    return logits, steps


def flipped_share(ids, ref_ids, layers: int) -> float:
    """The share of (token, layer) pairs of the first ``layers`` routing
    calls (a prefill's) whose top-k expert sets differ."""
    flips = [(a.sort(-1).values != b.sort(-1).values).any(-1).float()
             for a, b in zip(ids[:layers], ref_ids[:layers])]
    return float(sum(f.sum() for f in flips) / sum(f.numel() for f in flips))


def recorded_tape(ids, dev) -> RouteTape:
    """A ``RouteTape`` that replays ``ids`` (another run's) on ``dev``."""
    tape = RouteTape()
    tape.ids = [i.to(dev) for i in ids]
    tape.replay()
    return tape


def lm_grid_zoo_serve(dev, smi: str) -> int:
    """Phase 16 (a) (see the module docstring); returns the grid
    prefill's flash_attention launches."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import decode_demo
    from repro_torch.launch.mesh import make_lm_grid
    from repro_torch.train.serve_step import params_shardings
    g = GRID_ZOO
    B, P, T = g["batch"], g["prompt"], g["new_tokens"]
    t0 = time.perf_counter()
    model, prompts = seeded_llama(g["arch"], B, P, dev)
    cfg = model.cfg
    log(f"[lmgridzoo] (a) {cfg.name} drawn in "
        f"{time.perf_counter() - t0:.1f}s; the single-device path first "
        f"(its logits and tokens kept), after a warm-up")
    decode_demo.serve(model, prompts[:, :256], 2)
    torch.cuda.empty_cache()
    with RouteTape() as one_tape:
        one = decode_demo.serve(model, prompts, T)
    ref = (one.prefill_logits, list(one.step_logits.split(1, dim=1)))
    ref_tokens, one_ms = one.tokens, (one.prefill_ms, one.decode_ms)
    del one
    torch.cuda.empty_cache()
    grid = make_lm_grid(data=1, model=1)
    try:
        params_shardings(grid, model)
        pre_c, step_c = grid_serve_counts(model, grid, prompts[:, :256])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        with RouteTape() as grid_tape:
            res = decode_demo.serve(model, prompts, T, grid=grid)
        launches = ops.launch_counts()
        by_variant = fa.launch_count_by_variant()
        L = cfg.n_layers
        require(launches["flash_attention"] == L == res.flash_launches
                and not any(n for k, n in launches.items()
                            if k != "flash_attention"),
                f"(a) the grid serve launched {launches}, want {L} "
                f"flash_attention and nothing else")
        require(by_variant == {"sm90_bf16": L, "fma_fp32": 0},
                f"(a) the grid prefill launched {by_variant}")
        require(bool(torch.isfinite(res.prefill_logits).all())
                and bool(torch.isfinite(res.step_logits).all()),
                "(a) non-finite logits")
        moe_layers = sum(1 for blk in model.layers
                         if blk.ffn_name == "moe")
        flipped = flipped_share(grid_tape.ids, one_tape.ids, moe_layers)
        own = _against(res.prefill_logits,
                       list(res.step_logits.split(1, dim=1)), *ref,
                       cfg.vocab)
        held = "its own routing"
        pre, steps, same = own
        if not (torch.equal(res.tokens, ref_tokens)
                and max(pre, steps) <= GRID_ONE_TOL):
            with recorded_tape(one_tape.ids, dev) as tape:
                forced = grid_fed(model, grid, prompts, ref_tokens)
            require(tape.replayed_all(), "(a) the replay's routing calls "
                    "differ from the single device's")
            pre, steps, same = _against(*forced, *ref, cfg.vocab)
            held = "the single device's recorded routing, fed its tokens"
        require(pre <= GRID_ONE_TOL and steps <= GRID_ONE_TOL,
                f"(a) grid against single device ({held}): prefill "
                f"{pre:.3e}, steps {steps:.3e} (> {GRID_ONE_TOL})")
        require(same == B * T, f"(a) greedy tokens equal in {same} of "
                f"{B * T} ({held})")
        log(f"[lmgridzoo] (a) 1 x 1 grid serve, {cfg.name} {cfg.dtype} "
            f"({sum(p.numel() for p in model.parameters()) / 1e9:.2f}B "
            f"parameters): prefill {B}x{P} {res.prefill_ms:.1f} ms "
            f"(single device {one_ms[0]:.1f}), {launches['flash_attention']}"
            f" flash_attention launches ({by_variant}); decode {T} steps "
            f"{res.decode_ms / T:.2f} ms/step (single device "
            f"{one_ms[1] / T:.2f}); collectives per prefill {pre_c}, per "
            f"decode step {step_c}; peak device memory "
            f"{res.peak_bytes / 1e9:.2f} GB; on {smi}")
        log(f"[lmgridzoo] (a) against the single-device path on "
            f"{held}: last-position logits relative difference {pre:.3e}, "
            f"steps at most {steps:.3e}; greedy tokens equal in {same} of "
            f"{B * T}; own routing: {own[0]:.3e} / {own[1]:.3e}, tokens "
            f"equal {own[2]}, top-{cfg.top_k} sets flipped in the prefill "
            f"{100 * flipped:.3f}% of the (token, layer) pairs")
        profile_grid_prefill(model, grid, prompts)
    finally:
        grid.destroy()
    del res, model
    torch.cuda.empty_cache()
    return launches["flash_attention"]


def profile_grid_prefill(model, grid, prompts, top: int = 10) -> None:
    """Phase 16 (a): the 1 x 1 grid's prefill and the single-device
    prefill on the same placed model, each once more under
    torch.profiler: wall, device busy time and idle share, and the
    ``top`` kernels by device time."""
    import torch
    from repro_torch.train import make_prefill_step
    for label, step in (("grid", make_prefill_step(model, grid=grid)),
                        ("single device", make_prefill_step(model))):
        wall, busy, events = profiled(lambda: step(prompts), host=False)
        log(f"[lmgridzoo] (a) profiled {label} prefill: wall "
            f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
            f"({100 * (1 - busy / wall):.1f}% idle)")
        for e in events[:top]:
            log(f"[lmgridzoo]   {e.device_time_total / 1e3:9.3f} ms "
                f"{100 * e.device_time_total / 1e6 / busy:5.1f}%  "
                f"x{e.count:<5d} {e.key[:70]}")
        torch.cuda.empty_cache()


def zoo_tp_cell(grid, refs: dict) -> dict:
    """Phase 16 (b), one cell of the 1 x 2 grid (a spawned process on the
    card): each arch seeded, placed and served through decode_demo.serve
    after a warm-up (what it launched, on which heads, its times and
    peak), then fed the single device's tokens (an MoE on its recorded
    routing); then the granite-moe train steps."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import decode_demo
    from repro_torch.train.serve_step import params_shardings
    t = GRID_ZOO_TP
    dev = grid.device
    out = {}
    flash = ops.flash_attention
    for arch, ref in refs.items():
        model, prompts = seeded_llama(arch, t["batch"], t["prompt"], dev)
        params_shardings(grid, model)
        pre_c, step_c = grid_serve_counts(model, grid, prompts[:, :256])
        heads = []

        def recorded(q, k, v, **kw):
            heads.append((q.shape[1], k.shape[1]))
            return flash(q, k, v, **kw)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        ops.flash_attention = recorded
        try:
            res = decode_demo.serve(model, prompts, t["new_tokens"],
                                    grid=grid)
        finally:
            ops.flash_attention = flash
        launches, variants = ops.launch_counts(), fa.launch_count_by_variant()
        tape = recorded_tape(ref["ids"], dev)
        with tape:
            logits, steps = grid_fed(model, grid, prompts,
                                     ref["tokens"].to(dev))
        out[arch] = {"prefill": logits.float().cpu(),
                     "steps": torch.cat(steps, 1).float().cpu(),
                     "own_tokens": res.tokens.cpu(), "launches": launches,
                     "variants": variants, "heads": heads,
                     "replayed": tape.replayed_all() or not ref["ids"],
                     "prefill_ms": res.prefill_ms,
                     "decode_ms": res.decode_ms, "peak": res.peak_bytes,
                     "collectives": (pre_c, step_c)}
        del model, res, logits, steps
        torch.cuda.empty_cache()
    out["train"] = zoo_tp_train(grid)
    return out


def zoo_train(cfg, dev, grid=None) -> tuple[list, object]:
    """GRID_ZOO_TP's train steps of ``cfg`` from the seed-0 state on the
    token stream's first batches, on one device or ``grid``, with
    --remat: each step's loss, grad norm, ms and collectives; and the
    last state."""
    import torch
    from repro_torch.data import TokenStreamConfig, batch_at
    from repro_torch.optim import AdamW
    from repro_torch.train import init_state, make_train_step
    t = GRID_ZOO_TP
    ds = TokenStreamConfig(vocab=cfg.vocab, batch=t["train_batch"],
                           seq=t["train_seq"])
    opt = AdamW(lr=t["lr"])
    state = init_state(cfg, opt, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev, grid=grid)
    step = make_train_step(cfg, grid=grid, optimizer=opt, remat=True)
    hist = []
    for s in range(t["train_steps"]):
        c0 = grid.collectives if grid is not None else 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch_at(ds, s))
        loss = float(m["loss"])
        hist.append(dict(loss=loss, grad_norm=float(m["grad_norm"]),
                         ms=1e3 * (time.perf_counter() - t0),
                         collectives=(grid.collectives - c0
                                      if grid is not None else 0)))
    return hist, state


def zoo_tp_train(grid) -> dict:
    """Phase 16 (b)'s granite-moe train steps on one cell of the 1 x 2
    grid: their history, the kernels launched and the peak."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    dev = grid.device
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    hist, state = zoo_train(ARCHS[GRID_ZOO_TP["archs"][0]], dev, grid)
    del state
    return {"hist": hist, "launches": ops.launch_counts(),
            "peak": torch.cuda.max_memory_allocated(dev)}


def zoo_single_refs(dev) -> tuple[dict, list]:
    """Phase 16 (b)'s single-device references, in this process before
    the grid starts: each arch served (its routing recorded) and kept on
    the host; then granite-moe's train steps from the grid's seed-0
    state on the grid's batches, with the grid's step (grid=None),
    optimizer and --remat: each step's loss and grad norm."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import decode_demo
    t = GRID_ZOO_TP
    refs = {}
    for arch in t["archs"]:
        model, prompts = seeded_llama(arch, t["batch"], t["prompt"], dev)
        with RouteTape() as tape:
            one = decode_demo.serve(model, prompts, t["new_tokens"])
        refs[arch] = {"prefill": one.prefill_logits.float().cpu(),
                      "steps": one.step_logits.float().cpu(),
                      "tokens": one.tokens.cpu(),
                      "ids": [i.cpu() for i in tape.ids]}
        del model, one, tape
        torch.cuda.empty_cache()
    hist, state = zoo_train(ARCHS[t["archs"][0]], dev)
    del state
    torch.cuda.empty_cache()
    return refs, hist


def lm_grid_zoo_tp(tmp: Path, dev, smi: str) -> None:
    """Phase 16 (b) (see the module docstring)."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import spawn_grid
    t = GRID_ZOO_TP
    B, T = t["batch"], t["new_tokens"]
    refs, one = zoo_single_refs(dev)
    t0 = time.perf_counter()
    cells = spawn_grid(zoo_tp_cell, tmp / "zoo_tp", data=1,
                       model=t["model"], lm=True, device="cuda",
                       args=(refs,), timeout_s=900)
    wall = time.perf_counter() - t0
    for arch, ref in refs.items():
        cfg = ARCHS[arch]
        L = cfg.n_layers
        want = ((cfg.n_heads // 2, cfg.n_kv // 2) if cfg.attn_impl == "gqa"
                else (cfg.n_heads // 2, cfg.n_heads // 2))
        for r, c in enumerate(x[arch] for x in cells):
            require(c["launches"]["flash_attention"] == L
                    and c["variants"] == {"sm90_bf16": L, "fma_fp32": 0}
                    and not any(n for k, n in c["launches"].items()
                                if k != "flash_attention"),
                    f"(b) {arch} rank {r} launched {c['launches']} "
                    f"{c['variants']}")
            require(set(c["heads"]) == {want}, f"(b) {arch} rank {r} "
                    f"attended (query, KV) heads {sorted(set(c['heads']))},"
                    f" want {want}")
            require(c["replayed"], f"(b) {arch} rank {r}: the recorded "
                    f"routing was not replayed call for call")
        c = cells[0][arch]
        require(torch.equal(c["own_tokens"], cells[1][arch]["own_tokens"]),
                f"(b) {arch}: the two model ranks' tokens differ")
        pre, steps, same = _against(
            c["prefill"], list(c["steps"].split(1, dim=1)), ref["prefill"],
            list(ref["steps"].split(1, dim=1)), cfg.vocab)
        held = ("on the single device's recorded routing, " if ref["ids"]
                else "")
        require(pre <= LM_BF16_TOL and steps <= LM_BF16_TOL,
                f"(b) {arch} TP = 2 against one device ({held}fed its "
                f"tokens): prefill {pre:.3e}, steps {steps:.3e} (> "
                f"{LM_BF16_TOL})")
        require(same >= GRID_TP_SAME * B * T,
                f"(b) {arch}: greedy tokens equal in {same} of {B * T}")
        own_same = int((c["own_tokens"] == ref["tokens"]).sum())
        log(f"[lmgridzoo] (b) {arch} on the 1 x 2 grid (gloo on CUDA "
            f"tensors): each rank {L} sm90_bf16 launches on {want[0]} query "
            f"and {want[1]} KV heads; prefill {B}x{t['prompt']} "
            + " / ".join(f"{x[arch]['prefill_ms']:.1f}" for x in cells)
            + " ms, decode " + " / ".join(
                f"{x[arch]['decode_ms'] / T:.2f}" for x in cells)
            + f" ms/step (ranks 0 / 1); collectives per prefill "
            f"{c['collectives'][0]}, per decode step {c['collectives'][1]}; "
            f"peak device memory per rank " + " / ".join(
                f"{x[arch]['peak'] / 1e9:.2f}" for x in cells)
            + f" GB; on {smi}")
        log(f"[lmgridzoo] (b) {arch} against the single device ({held}fed "
            f"its tokens): last-position logits {pre:.3e}, steps at most "
            f"{steps:.3e} (within {LM_BF16_TOL}); greedy tokens equal in "
            f"{same} of {B * T}; on its own routing and tokens, "
            f"{own_same} of {B * (T + 1)} tokens equal the single "
            f"device's")
    hist = [x["train"]["hist"] for x in cells]
    for r, x in enumerate(cells):
        no_launches(f"(b) grid train rank {r}", x["train"]["launches"])
        require(all(math.isfinite(h["loss"]) for h in x["train"]["hist"]),
                f"(b) rank {r}: a non-finite train loss")
    require(all(a["loss"] == b["loss"] for a, b in zip(*hist)),
            "(b) the two model ranks' train losses differ")
    rels = {(key, s): abs(g[key] - o[key]) / abs(o[key])
            for key in ("loss", "grad_norm")
            for s, (g, o) in enumerate(zip(hist[0], one))}
    log(f"[lmgridzoo] (b) {t['archs'][0]} tensor-parallel training on the "
        f"1 x 2 grid, batch {t['train_batch']} x seq {t['train_seq']}, "
        f"--remat: losses " + " ".join(f"{h['loss']:.5f}" for h in hist[0])
        + " against the single device's " + " ".join(
            f"{h['loss']:.5f}" for h in one) + "; grad_norm " + " ".join(
            f"{h['grad_norm']:.4f}" for h in hist[0]) + " against "
        + " ".join(f"{h['grad_norm']:.4f}" for h in one)
        + "; relative differences " + ", ".join(
            f"{k} {s + 1} {r:.3e}" for (k, s), r in rels.items())
        + f" (within {GRID_LOSS_TOL} at step 1, {GRID_ZOO_UPDATED_TOL} "
        f"after an update); ms per step "
        + " / ".join(" ".join(f"{h['ms']:.1f}" for h in x) for x in hist)
        + " (ranks 0 / 1); collectives per step "
        + " ".join(str(h["collectives"]) for h in hist[0])
        + "; peak device memory per rank " + " / ".join(
            f"{x['train']['peak'] / 1e9:.2f}" for x in cells)
        + f" GB; {wall:.1f}s wall with start-up; on {smi}")
    for (key, s), rel in rels.items():
        tol = GRID_LOSS_TOL if s == 0 else GRID_ZOO_UPDATED_TOL
        require(rel <= tol, f"(b) grid train step {s + 1} {key} "
                f"{hist[0][s][key]} against the single device's "
                f"{one[s][key]} ({rel:.3e} > {tol})")


def phase_lm_grid_zoo(tmp: Path, dev, smi: str) -> int:
    """Phase 16 (see the module docstring); returns (a)'s flash_attention
    launches per grid prefill."""
    import torch
    log(f"[lmgridzoo] {smi}")
    t0 = time.perf_counter()
    launches = lm_grid_zoo_serve(dev, smi)
    torch.cuda.empty_cache()
    log(f"[lmgridzoo] (a) {time.perf_counter() - t0:.1f}s wall")
    lm_grid_zoo_tp(tmp, dev, smi)
    log(f"[lmgridzoo] phase 16 {time.perf_counter() - t0:.1f}s wall")
    return launches


# ---------------------------------------------------------------------------
# Phase 17: one rank's share of the exascale cells
# ---------------------------------------------------------------------------

def counted_share(tag: str, card: dict, meta: dict, ms: float, peak: float,
                  smi: str) -> float:
    """Phase 18: a step's count on the card (``StepCounter.summary``)
    held equal to its count on meta tensors, then its achieved rates and
    roofline share against ``ms``, the phase's own timing of the step;
    returns the share."""
    if card != meta:
        diff = {k: (card[k], meta[k]) for k in card if card[k] != meta[k]}
        require(False, f"[costs] {tag}: the card's count differs from the "
                f"meta count: {diff}")
    flops, nbytes = card["flops"], card["bytes"]
    share = max(flops / peak, nbytes / PEAK_BYTES_PER_S) * 1e3 / ms
    kernels = ", ".join(f"{k} {v}" for k, v in card["ops"].items()
                        if k.startswith("kernel:")) or "no kernel"
    top = sorted(card["bytes_by_op"].items(), key=lambda kv: -kv[1])[:4]
    log(f"[costs] phase 18 {tag} ({smi}): counted {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e9:.3f} GB, {sum(card['ops'].values())} ops "
        f"({kernels}), "
        f"{card['collectives']['total']['count']} collectives, equal on the "
        f"card and on meta; timed {ms:.3f} ms: {flops / ms / 1e9:.2f} "
        f"TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s, roofline share "
        f"{share:.3f} (peak {peak / 1e12:.0f} TFLOP/s, "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s); most bytes: "
        + ", ".join(f"{k} {100 * v / nbytes:.1f}%" for k, v in top))
    require(share <= ROOFLINE_MAX,
            f"[costs] {tag}: roofline share {share:.3f} > {ROOFLINE_MAX}: "
            f"the count missed work")
    return share


def count_lm_steps(res, smi: str) -> None:
    """Phase 18's LM half on phase 8's resident model: the prefill of its
    prompts and one decode step from its cache, counted on the card and
    on the model rebuilt on meta tensors."""
    import torch
    from repro_torch.launch.step_costs import StepCounter
    from repro_torch.models.model import greedy_sample
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.serve_step import (make_prefill_step,
                                              make_serve_step)
    t0 = time.perf_counter()
    T = LM["new_tokens"]
    counts = {}
    for where, model, prompts in (
            ("card", res.model, res.prompts),
            ("meta", Transformer(res.model.cfg, device="meta"),
             torch.empty(res.prompts.shape, dtype=res.prompts.dtype,
                         device="meta"))):
        P = prompts.shape[1]
        prefill = make_prefill_step(model, max_len=P + T)
        with StepCounter() as pre:
            logits, filled = prefill(prompts)
        with torch.inference_mode():
            cache = model.extend_cache(filled, P + T)
        del filled
        tok = greedy_sample(logits, model.cfg.vocab)
        step = make_serve_step(model)
        with StepCounter() as dec:
            step(cache, tok, P)
        counts[where] = (pre.summary(), dec.summary())
        del logits, cache, tok
    torch.cuda.empty_cache()
    counted_share(f"llama3.2-1b prefill {tuple(res.prompts.shape)}",
                  counts["card"][0], counts["meta"][0], res.prefill_ms,
                  PEAK_BF16_FLOP_PER_S, smi)
    counted_share("llama3.2-1b decode step", counts["card"][1],
                  counts["meta"][1], res.decode_ms / T,
                  PEAK_BF16_FLOP_PER_S, smi)
    COUNT_S.append(time.perf_counter() - t0)
    log(f"[costs] phase 18 LM counts {COUNT_S[-1]:.1f}s")


def exa_terms(tag: str, plan11: dict, plan16: dict) -> None:
    """The 1 x 1 plan at the share's shapes beside the 16 x 16 plan, term
    by term (GB; the terms of 1 MB or more), and their difference."""
    names = list(dict.fromkeys([*plan11["terms"], *plan16["terms"]]))
    for name in names:
        a = plan11["terms"].get(name, 0)
        b = plan16["terms"].get(name, 0)
        if max(a, b) < 1e6:
            continue
        log(f"[exascale] {tag}   {name:<44} 1x1 {a / 1e9:8.3f}  16x16 "
            f"{b / 1e9:8.3f}  diff {(a - b) / 1e9:+8.3f}")


def exa_share(tag: str, grid, Xl, factors: dict, schedule: str,
              plan11: dict, plan16: dict, names: tuple[str, ...],
              dev) -> dict:
    """One share through ``make_mu_step`` (fused, ``schedule``): one MU
    iteration held against the plain path, then EXA_ITERS timed with the
    counters and the allocator's peak reset just before; returns the
    launches, ms per iteration, the peak and the final factors.  The
    factors {"A", "R"} are taken out of ``factors``, so that each
    iteration's input A is freed once the next exists, as the plan
    counts it."""
    import torch
    Ai, R = factors.pop("A"), factors.pop("R")
    from repro_torch.dist.engine import DistRescalConfig, make_mu_step
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    fused = DistRescalConfig(schedule=schedule,
                             kernel=KernelPolicy(use_fused=True))
    plain = DistRescalConfig(schedule=schedule,
                             kernel=KernelPolicy(use_fused=True, impl="ref"))
    step = make_mu_step(grid, fused)
    t0 = time.perf_counter()
    A_ref, R_ref = make_mu_step(grid, plain)(Xl, Ai, R)
    A_k, R_k = step(Xl, Ai, R)
    torch.cuda.synchronize()
    err_a = compare(f"{tag} A after one MU iteration", A_k, A_ref)
    err_r = compare(f"{tag} R after one MU iteration", R_k, R_ref)
    log(f"[exascale] {tag} one MU iteration, kernel vs plain path: A max "
        f"|diff| {err_a:.3e}, R {err_r:.3e} (phase 2's tolerances; "
        f"{time.perf_counter() - t0:.1f}s)")
    del A_ref, R_ref, A_k, R_k
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ops.reset_launch_counts()
    c0 = grid.collectives
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(EXA_ITERS):
        Ai, R = step(Xl, Ai, R)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / EXA_ITERS
    peak = torch.cuda.max_memory_allocated(dev)
    launches = ops.launch_counts()
    coll = (grid.collectives - c0) // EXA_ITERS
    require(bool(torch.isfinite(Ai).all()) and bool(torch.isfinite(R).all()),
            f"{tag}: non-finite factors after {EXA_ITERS} MU iterations")
    for name in names:
        require(launches[name] > 0, f"{tag}: {name} never launched")
    require(coll == plan11["collectives"]["count"],
            f"{tag}: {coll} collectives per MU iteration, the plan says "
            f"{plan11['collectives']['count']}")
    mem = plan11["memory"]
    total = mem["total"]
    off = abs(peak - total) / total
    # the step's own allocations: what the plan's output and temp count,
    # beside the operand and factors that dominate the total
    step_b, step_plan = peak - base, mem["output"] + mem["temp"]
    step_off = abs(step_b - step_plan) / step_plan
    log(f"[exascale] {tag} {schedule}: {ms:.3f} ms per MU iteration "
        f"({EXA_ITERS} iterations, CUDA events); launches {launches}; "
        f"{coll} collectives per iteration (the plan's "
        f"{plan11['collectives']['count']}); peak device memory "
        f"{peak / 1e9:.3f} GB, the 1 x 1 plan {total / 1e9:.3f} GB "
        f"({100 * (peak - total) / total:+.2f}%), the 16 x 16 plan "
        f"{plan16['memory']['total'] / 1e9:.3f} GB per rank; the step's "
        f"own allocations (peak - {base / 1e9:.3f} GB held before) "
        f"{step_b / 1e9:.4f} GB, the plan's output + temp "
        f"{step_plan / 1e9:.4f} GB ({100 * (step_b - step_plan) / step_plan:+.2f}%)")
    exa_terms(tag, plan11, plan16)
    from repro_torch.launch.step_costs import StepCounter
    t_count = time.perf_counter()
    with StepCounter() as counted:          # phase 18: one more iteration
        step(Xl, Ai, R)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t_count
    require(off <= EXA_PEAK_TOL,
            f"{tag}: peak {peak / 1e9:.3f} GB is {100 * off:.1f}% from the "
            f"plan's {total / 1e9:.3f} GB (> {100 * EXA_PEAK_TOL:.0f}%)")
    require(step_off <= EXA_PEAK_TOL,
            f"{tag}: the step's own allocations {step_b / 1e9:.4f} GB are "
            f"{100 * step_off:.1f}% from the plan's output + temp "
            f"{step_plan / 1e9:.4f} GB (> {100 * EXA_PEAK_TOL:.0f}%)")
    return {"launches": launches, "ms": ms, "peak": peak, "A": Ai, "R": R,
            "counted": counted.summary(), "count_s": count_s}


def meta_count(tag: str, cfg, card_s: float) -> dict:
    """Phase 18: the share's MU iteration counted on meta tensors on a
    1 x 1 recording grid; logs the part's seconds (the card's counted
    iteration took ``card_s``)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    meta = dryrun.count_rescal(cfg, 1).summary()
    meta_s = time.perf_counter() - t0
    COUNT_S.append(card_s + meta_s)
    log(f"[costs] phase 18 {tag} counts {COUNT_S[-1]:.1f}s (the card's "
        f"iteration {card_s:.2f}s, meta {meta_s:.2f}s)")
    return meta


def exa_bcsr(sh, gen, dev):
    """The sparse share's BCSR: sh.nnzb blocks of sh.bs^2 per slice at
    seeded uniform positions over (nb, nb), row-major, uniform values."""
    import numpy as np
    import torch
    from repro_torch.core.sparse import BCSR
    rng = np.random.default_rng(EXA["seed"])
    nb = sh.nb
    flat = np.unique(rng.integers(0, nb * nb, size=2 * sh.nnzb))
    flat = np.sort(rng.choice(flat, size=sh.nnzb, replace=False))
    rows = torch.from_numpy((flat // nb).astype(np.int32)).to(dev)
    cols = torch.from_numpy((flat % nb).astype(np.int32)).to(dev)
    data = torch.rand((sh.m, sh.nnzb, sh.bs, sh.bs), generator=gen,
                      device=dev)
    return BCSR(data=data, block_rows=rows, block_cols=cols, n=sh.nl)


def exa_spmm(sp, A) -> None:
    """(b)'s product X_t A of every slice, (m, n_loc, k) past 2^31
    outputs: one ``bcsr_spmm`` launch, held against the plain segment sum
    EXA_SPMM_SLICES slices at a time."""
    import torch
    from repro_torch.core.sparse import single_product
    from repro_torch.kernels.policy import KernelPolicy
    t0 = time.perf_counter()
    P = single_product(sp, A, policy=KernelPolicy(use_fused=True))
    require(tuple(P.shape) == (sp.m, sp.n, A.shape[-1]),
            f"(b) bcsr_spmm product {tuple(P.shape)}")
    plain = KernelPolicy(use_fused=True, impl="ref")
    worst = rel = share = 0.0
    for a in range(0, sp.m, EXA_SPMM_SLICES):
        b = min(a + EXA_SPMM_SLICES, sp.m)
        ref = single_product(sp.with_data(sp.data[a:b]), A, policy=plain)
        err = compare(f"(b) bcsr_spmm slices {a}..{b - 1}", P[a:b], ref)
        worst = max(worst, err)
        share = max(share, err / float(ref.abs().max()))
        rel = max(rel, float(torch.linalg.vector_norm(P[a:b] - ref))
                  / float(torch.linalg.vector_norm(ref)))
        del ref
    log(f"[exascale] (b) bcsr_spmm product {tuple(P.shape)}, "
        f"{P.numel():,} outputs (2^31 = {2 ** 31:,}): against the plain "
        f"segment sum, {EXA_SPMM_SLICES} slices at a time, max |diff| "
        f"{worst:.3e}, at most {share:.3e} of a chunk's max |ref| (limit "
        f"{ABS_TOL}) and {rel:.3e} relative (limit {REL_TOL}) "
        f"({time.perf_counter() - t0:.1f}s)")
    del P
    torch.cuda.empty_cache()


def exa_lm_plans() -> None:
    """The dry run's plan of each LM cell this run measured, at that
    phase's own cut shape on a 1 x 1 grid, beside its measured peak: the
    plan's state terms alone must not exceed it, and its total with the
    fit's margin (``dryrun.LM_PLAN_SHORTFALL``) must reach it."""
    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.launch import dryrun
    cells = {"llama3.2-1b serve": (ARCHS[LM["arch"]], ShapeSpec(
                 "lm", "prefill", LM["prompt"] + LM["new_tokens"],
                 LM["batch"])),
             "llama3.2-1b train": (ARCHS[TRAIN["arch"]], ShapeSpec(
                 "train", "train", TRAIN["seq"], TRAIN["batch"])),
             f"{ZOO_SERVE['arch']} serve": (ARCHS[ZOO_SERVE["arch"]],
                                            ShapeSpec(
                 "zoo", "prefill",
                 ZOO_SERVE["prompt"] + ZOO_SERVE["new_tokens"],
                 ZOO_SERVE["batch"]))}
    for tag, (cfg, spec) in cells.items():
        require(tag in MEASURED_PEAKS, f"no measured peak for {tag}")
        peak = MEASURED_PEAKS[tag]
        plan = dryrun.plan_lm(cfg, spec, 1, 1, 1, remat=True)
        require("refused" not in plan, f"{tag}: {plan.get('refused')}")
        total, state = plan["memory"]["total"], plan["state_bytes"]
        margin = plan["memory"]["fit_margin"]
        log(f"[exascale] LM {tag} ({spec.global_batch} x {spec.seq_len}, "
            f"1 x 1): measured peak {peak / 1e9:.2f} GB; plan total "
            f"{total / 1e9:.2f} GB (ratio {total / peak:.3f}; with the "
            f"fit's {100 * margin:.1f}% margin "
            f"{total * (1 + margin) / 1e9:.2f}), state terms "
            f"{state / 1e9:.2f} GB ("
            + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in
                        plan["terms"].items())
            + ")")
        require(state <= peak, f"{tag}: the plan's state terms "
                f"{state / 1e9:.2f} GB exceed the measured peak "
                f"{peak / 1e9:.2f} GB")
        require(total * (1 + margin) >= peak,
                f"{tag}: the plan's total {total / 1e9:.2f} GB with the "
                f"fit's {100 * margin:.1f}% margin is below the measured "
                f"peak {peak / 1e9:.2f} GB (dryrun.LM_PLAN_SHORTFALL)")


def phase_exascale(rows: list[dict], dev, smi: str) -> None:
    """Phase 17 (see the module docstring); sets the kernels line's
    launches of the four RESCAL kernels to this phase's."""
    import dataclasses

    import torch
    from repro_torch.configs.rescal_paper import (RESCAL_DENSE_3TB,
                                                  RESCAL_SPARSE_EB)
    from repro_torch.dist.engine import local_rel_error_bcsr
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_grid
    log(f"[exascale] {smi}")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(EXA["seed"])
    grid = make_grid(data=1, model=1, device=dev)
    counts: dict[str, int] = {}
    try:
        # (a) the dense cell's share, batched
        cfg = RESCAL_DENSE_3TB
        sh = dryrun.rescal_share(cfg, 16)
        plan16 = dryrun.plan_rescal(cfg, 16)
        plan11 = dryrun.plan_rescal(dataclasses.replace(cfg, n=sh.nl), 1)
        k = EXA["k"]
        require(k == cfg.k, f"k {k} is not the cell's {cfg.k}")
        X = torch.rand((sh.m, sh.nl, sh.nl), generator=gen, device=dev)
        log(f"[exascale] (a) {cfg.name}: X^(i,j) {tuple(X.shape)} fp32, "
            f"{X.numel() * 4 / 1e9:.2f} GB, {X.numel():,} floats "
            f"(2^31 = {2 ** 31:,})")
        factors = {"A": torch.rand((sh.nl, k), generator=gen, device=dev),
                   "R": torch.rand((sh.m, k, k), generator=gen, device=dev)}
        out = exa_share("(a)", grid, X, factors, "batched", plan11, plan16,
                        ("fused_xa_xtb", "mu_update_a"), dev)
        share = counted_share(
            f"(a) {cfg.name} MU iteration", out["counted"],
            meta_count("(a)", dataclasses.replace(cfg, n=sh.nl),
                       out["count_s"]), out["ms"], PEAK_FP32_FLOP_PER_S, smi)
        log(f"[costs] phase 18 (a): the dense share's roofline share "
            f"{share:.3f} (X's {X.numel() * 4 / 1e9:.2f} GB alone: "
            f"{X.numel() * 4 / PEAK_BYTES_PER_S * 1e3 / out['ms']:.3f})")
        require(out["launches"]["fused_xa_xtb"] == EXA_ITERS
                and out["launches"]["mu_update_a"] == EXA_ITERS,
                f"(a) launches {out['launches']}, want one fused_xa_xtb "
                f"and one mu_update_a per MU iteration")
        for name, n in out["launches"].items():
            counts[name] = counts.get(name, 0) + n
        del X, out
        torch.cuda.empty_cache()

        # (b) the sparse cell's share, per slice
        cfg = RESCAL_SPARSE_EB
        sh = dryrun.rescal_share(cfg, 16)
        plan16 = dryrun.plan_rescal(cfg, 16)
        plan11 = dryrun.plan_rescal(dataclasses.replace(cfg, n=sh.nl), 1)
        require(plan11["local"]["nnzb"] == sh.nnzb,
                f"the 1 x 1 plan has {plan11['local']['nnzb']} blocks per "
                f"slice, the share {sh.nnzb}")
        t1 = time.perf_counter()
        sp = exa_bcsr(sh, gen, dev)
        torch.cuda.synchronize()
        log(f"[exascale] (b) {cfg.name}: n_loc {sh.nl:,}, nb_loc "
            f"{sh.nb:,}, {sh.nnzb} blocks of {sh.bs}^2 per slice "
            f"(local density {sh.nnzb / sh.nb ** 2:.2e}), m = {sh.m}: "
            f"{sp.data.numel() * 4 / 1e9:.2f} GB of data, built in "
            f"{time.perf_counter() - t1:.1f}s; A^(i) ({sh.nl:,}, {k}) "
            f"{sh.nl * k * 4 / 1e9:.2f} GB")
        factors = {"A": torch.rand((sh.nl, k), generator=gen, device=dev),
                   "R": torch.rand((sh.m, k, k), generator=gen, device=dev)}
        out = exa_share("(b)", grid, sp, factors, "sliced", plan11, plan16,
                        ("bcsr_xa_xta", "mu_update_a"), dev)
        counted_share(f"(b) {cfg.name} MU iteration", out["counted"],
                      meta_count("(b)", dataclasses.replace(cfg, n=sh.nl),
                                 out["count_s"]), out["ms"],
                      PEAK_FP32_FLOP_PER_S, smi)
        require(out["launches"]["bcsr_xa_xta"] == EXA_ITERS * sh.m
                and out["launches"]["mu_update_a"] == EXA_ITERS,
                f"(b) launches {out['launches']}, want one bcsr_xa_xta per "
                f"slice and one mu_update_a per MU iteration")
        A, R = out.pop("A"), out.pop("R")
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        err = local_rel_error_bcsr(grid, sp, A, R,
                                   policy=KernelPolicy(use_fused=True))
        err_peak = torch.cuda.max_memory_allocated(dev)
        spmm = ops.launch_counts()["bcsr_spmm"]
        require(spmm == 1, f"(b) bcsr_spmm launched {spmm} times for the "
                f"relative error, want 1")
        out["launches"]["bcsr_spmm"] = spmm
        torch.cuda.empty_cache()
        ref = local_rel_error_bcsr(
            grid, sp, A, R, policy=KernelPolicy(use_fused=True, impl="ref"))
        e, e_ref = float(err), float(ref)
        require(math.isfinite(e) and 0 <= e <= 1.0 + 1e-6
                and abs(e - e_ref) <= SWEEP_TOL * max(e_ref, 1e-12),
                f"(b) relative error {e} against the plain path's {e_ref}")
        log(f"[exascale] (b) relative error after {EXA_ITERS} MU "
            f"iterations {e:.6f} (plain path {e_ref:.6f}); its peak "
            f"{err_peak / 1e9:.2f} GB (the (m, n_loc, k) product and its "
            f"all-reduce)")
        del err, ref
        torch.cuda.empty_cache()
        exa_spmm(sp, A)
        for name, n in out["launches"].items():
            counts[name] = counts.get(name, 0) + n
        del sp, A, R, out
        torch.cuda.empty_cache()
    finally:
        grid.destroy()
    exa_lm_plans()
    for row in rows:
        if row["name"] in ("bcsr_xa_xta", "bcsr_spmm", "fused_xa_xtb",
                           "mu_update_a"):
            log(f"[exascale] {row['name']}: launches {counts[row['name']]} "
                f"in phase 17 (earlier phases' line: {row['launches']})")
            row["launches"] = counts[row["name"]]
    log(f"[exascale] phase 17 {time.perf_counter() - t0:.1f}s wall")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}; run "
              f"from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import device as _device
    _device.strict_fp32()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = smi_line()
    log(f"[card] {smi} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    phase_build()
    rows = phase_kernels(dev) + [phase_fused(dev), phase_mu(dev),
                                 phase_topk(dev)]
    by_name = {row["name"]: row for row in rows}
    with tempfile.TemporaryDirectory() as tmp:
        bundle, res3, rep3 = phase_sweeps(rows, Path(tmp))
        served = phase_serve(bundle, by_name["score_topk"], dev)
        torch.cuda.empty_cache()
        phase_telemetry(Path(tmp), (res3, rep3), served)
        torch.cuda.empty_cache()
        grid_res = phase_grid(by_name["fused_xa_xtb"], Path(tmp), dev)
        phase_dense(by_name, grid_res, Path(tmp))
        torch.cuda.empty_cache()
        phase_virtual(Path(tmp), rep3, dev, smi)
        torch.cuda.empty_cache()
        phase_chaos(Path(tmp), dev, smi)
        torch.cuda.empty_cache()
        phase_grid_sweep(Path(tmp), dev, smi)
        torch.cuda.empty_cache()
        phase_train(Path(tmp), dev, smi)
    torch.cuda.empty_cache()
    rows.append(phase_lm(dev, smi))
    torch.cuda.empty_cache()
    phase_zoo(dev, smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase_lm_grid(Path(tmp), dev, smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_lm_grid_zoo(Path(tmp), dev, smi)
    # flash_attention's launches: this slice's main path, a grid prefill
    # of deepseek-moe-16b (phase 16 (a))
    next(r for r in rows if r["name"] == "flash_attention")[
        "launches"] = launches
    torch.cuda.empty_cache()
    phase_exascale(rows, dev, smi)
    log(f"[costs] phase 18 in all {sum(COUNT_S):.1f}s")
    for row in rows:
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if row[key] is not None:
                require(math.isfinite(row[key]) and row[key] > 0,
                        f"{row['name']}: bad {key} {row[key]}")
    for row in rows:
        log(f"[kernels] {row['name']}: launches {row['launches']}, kernel "
            f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms, library {row['library_ms']}")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
