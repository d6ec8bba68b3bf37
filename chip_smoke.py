#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch / CUDA port (one NVIDIA H100).

    python3 chip_smoke.py            # everything; needs one CUDA device

Phases (any failure exits nonzero and prints no result line):

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, the TF32 flags;
  2. build: every kernel from ``distributed_kfac_pytorch_tpu_torch/csrc``
     with nvcc for sm_90a (``ops.kernels.build``);
  3. kernels K1-K3: each at the shapes of the ResNet-32 / batch-128 path
     and of the ResNet-50 / 224 px / batch-64 path (K3 also at the LSTM
     LM's (16, 650, 651) bucket, eigen and baked; K1 and K3 at the
     Transformer-XL step's shapes: row-major (4096, 1024) and (4096,
     4096) with and without the bias column, and the baked buckets (72,
     1024, 1025), (18, 4096, 1025), (18, 1024, 4097)) plus ragged edge
     cases, fp32 and bf16-multiplicand modes, held against its plain
     PyTorch version on the same inputs on the card (relative to the
     largest plain entry: fp32 <= 1e-5 for the Gram kernels, <= 1e-4 for
     bucketed preconditioning; bf16 <= 1e-2), and timed with CUDA events
     (median) beside the plain version, a library yardstick and the
     card's bound (K1-K3 against the 3xTF32 tensor-core rate, their fp32
     CUDA-core bound beside it) and the bound's share of the time; K1 and
     K2 also at one edge case per staging path of ``factor_ema_plan`` and
     ``patch_cov_plan``, their outputs exactly symmetric; K1-K3
     bit-identical over two calls; on every K1 case (fp32),
     ``kernels.ema_blend`` of the contraction alone equal bit for bit to
     the fused blend; each case printing its plan (K1, K2:
     tile, pairs, chunks, staging path; K3: tile, staging path, waves from
     ``bucket_precond_plan``); then K1-K3 at the ResNet-152 / 224 px /
     batch-64 shapes in tracked config 5's modes: K1 in bf16-storage mode
     (``old`` and the result bf16) on every case, bit for bit against
     the widen, fp32 launch, round sequence and timed beside it, the
     stored blend within one bf16 ulp of the largest plain entry; K1 and
     K2 timed with bf16 multiplicands (bound against the bf16 tensor-core
     rate); K3 on every eigen bucket, also fed bf16 stacks (fp32 and bf16
     modes, the usual tolerances); and K1 in bf16-storage mode at one
     Transformer-XL shape, checked and timed the same way; then K1-K3 at
     the ViT-S/16 step's shapes (224 px, batch 64: K1 on every Linear's
     ``(64 * 197, 384)`` and ``(64 * 197, 1536)`` rows with and without
     the bias column, the head's rows and the patch conv's G; K2 on the
     patch embedding, kernel = stride = 16, no padding, 768 features
     plus the bias; K3 on its five buckets in the forms ``auto`` gives
     them) and K1-K3 at the MobileNetV1 step's (176 px, batch 64: K1 on
     the stem's and the pointwise convs' G and the fc's A and G, K2 on
     their A, the 3x3/2 stem and the 1x1 convs, five of 512 channels at
     11 px among them, K3 on the eleven buckets in their ``auto`` forms),
     each held and timed the same way; then K1 and K2 over the whole
     ResNet-50 ``--fp16`` step's launch set (55 and 53) on that step's own
     captures (fp16 activations into K2 after the stem and into the fc's
     A; fp32 unscaled output-grads into K1's G sides), each within 1e-5 of
     its plain version on the same inputs and, on an fp16 input, bit for
     bit the launch on the input widened first; the set timed on those
     inputs and on the inputs widened beforehand (the widening's cost per
     step), beside the plain versions, the library yardsticks and the
     bound of the fp16-input bytes;
  4. kernel K4 (Newton--Schulz inverse): random SPD stacks at every
     ResNet-50 size bucket and edge sizes, damping 0.003 and 0.001, and
     stacks whose matrices stop at different iterations (and at the cap),
     against its plain version: relative Frobenius error <= 1e-4 for
     n <= 1024; above, the final ``max|MX - I|`` at most 2x the plain
     version's and iteration counts within +-1; timed beside the plain
     version, ``torch.cholesky_inverse(torch.linalg.cholesky(M))`` (the
     same operator by another algorithm) and two bounds: the tensor-core
     bound its time is read against (3 TF32 products per fp32 product at
     494.7 TFLOP/s) and the fp32 CUDA-core bound;
  5. main path, ResNet-32: ``train_cifar10_resnet.train``, batch 128, 30
     K-FAC steps on one fixed synthetic batch; every loss finite, the last
     five below the first five, launches factor_ema 33, patch_cov 31,
     bucket_precond 7 per step, ns_inverse 0;
  6. main path, ResNet-50: ``train_imagenet_resnet.train``, 224 px, batch
     64, one fixed synthetic batch, ``--inverse-method newton``, factors
     every step, inverses every 10, 12 steps (firings at steps 0 and 10);
     every loss finite, the last three below the first three, launches
     factor_ema 55, patch_cov 53, bucket_precond 21 per step, ns_inverse
     13 per firing; then each size bucket of the final factors through K4
     (iterations, residual, ms) beside the plain version's iterations and
     residual (untimed);
  7. ResNet-50 under the default ``--inverse-method auto``: 3 steps, one
     firing; finite losses, no ns_inverse launch, bucket_precond 21 per
     step split between eigen and baked buckets;
  8. kernel K5 (Jacobi eigh): random SPD stacks at the LSTM LM's two
     size buckets (16 x 651, 16 x 650), the nine ResNet-32 buckets, edge
     sizes 1, 2, 3, 64, 65, for each cluster size the largest size that
     takes it (the largest of all is the cluster path's capacity), one
     size just above the capacity (the streaming path), all read from
     ``jacobi_cluster_plan``, and an identity stack, against its plain
     version (the edge sizes and the identity stack, which are not
     timed, run beside phases 20 and 22, their lines printed there):
     eigenvalues <= 1e-5 of the largest, ``max|Q^T Q - I|`` and
     reconstruction <= 5e-5, the damped side inverse ``Q diag(1/(d +
     0.003)) Q^T`` <= 1e-4 relative; where one of these fails, the
     kernel's errors against a float64 eigh at most 2x the plain
     version's; timed beside the plain version (one run),
     ``torch.linalg.eigh`` and the bound; each row prints its path
     (cluster size C, the card's max active clusters and the waves per
     launch, or the streaming path) and whether ``|dQ|`` is exactly 0;
  9. main path, LSTM LM: ``train_language_model.train`` at the PTB-medium
     widths (650/650, 2 layers, 8-gate cell), synthetic vocabulary 10,000,
     batch 20, BPTT 35, dropout 0.5, one fixed batch, ``--inverse-method
     eigen --eigh-method jacobi``, 12 steps (firings at 0 and 10); every
     loss finite, the last three below the first three, launches
     bucket_precond 1 per step, jacobi_eigh 2 per firing, none of
     factor_ema, patch_cov, ns_inverse;
 10. the LM CLI defaults (``auto``: damped Cholesky at 650/651), 3 steps:
     finite losses, no jacobi_eigh launch;
 11. ResNet-32 under ``--eigh-method jacobi``: 11 steps, finite losses,
     jacobi_eigh 9 per firing besides phase 5's per-step launches;
 12. the result (printed after phases 13-40): a JSON line of
     per-kernel numbers (K1-K3 per ResNet-50 step, K4 per ResNet-50 firing, K5
     per LSTM firing, under ``transformer_xl`` K1 and K3 per XL step and K4 per
     XL firing, under ``resnet152_config5`` K1-K3 per config-5 step, and under
     ``vit_small`` and ``mobilenet_v1`` K1-K3 per ViT-S/16 and MobileNetV1
     step, under ``resnet50_fp16`` K1 and K2 per ResNet-50 ``--fp16`` step
     on its own captures; launches summed over phases 5-7, 9-11 and
     13-40), the card line,
     then ``{"ok": true, "device": {...}}`` as the last line;
 13. distributed, NCCL at world size 1: phase 6's ResNet-50 run through
     ``train_imagenet_resnet.train`` inside a one-rank NCCL group
     (``file://`` rendezvous under ``chiprun_out/``), ``--comm-method
     comm-opt``, so K-FAC runs as ``parallel.DistributedKFAC``; every loss
     finite and falling, the losses of steps 0-2 within 1e-3 relative of
     phase 6's and the mean of the last three within 5e-2 (phase 6 is
     not reproducible beyond that: its backward convolutions are
     nondeterministic and the 12-step run amplifies the difference),
     phase 6's launches, its step times printed beside phase 6's; then,
     in the same group, 12 steps of shared inputs: one capture per step
     into both the single-device ``KFAC`` and ``DistributedKFAC``, every
     step's factors (<= 1e-5), preconditioned gradients (<= 1e-4) and
     KL-clip scale (<= 1e-5) held against the single-device ones, as
     phase 14 holds its ranks;
 14. distributed, gloo: 4 ranks (subprocesses of this script, all on
     ``cuda:0``, started after the build) train ResNet-32 at full width
     with BatchNorm in eval mode (running statistics from one pass over
     the global batch) on their slices of one global batch of 128, under COMM_OPT (1 x 4), MEM_OPT (4 x 1) and HYBRID_OPT with
     fraction 0.5 (2 x 2), 3 steps each, inverses every 2nd, ``eigen`` +
     ``eigh_method='xla'``, then HYBRID_OPT once more under ``'jacobi'``;
     rank 0 holds every step against the single-device ``KFAC`` on the
     full batch (factors <= 1e-5, preconditioned gradients <= 1e-4 and
     the KL-clip scale <= 1e-5, each relative to the largest reference
     entry), every rank's launches must equal what the work assignment
     predicts (K1 33 and K2 31 per step; K3 one per gradient shape its
     row owns; K5 one per bucket it holds a slot of, per firing), and
     the step times print labelled as gloo through host memory; both
     sides collect the on-device metrics (``collect_metrics``): rank 0
     holds ``nu`` and the gradient norm (<= 1e-5), the preconditioned and
     bucket norms (<= 1e-4) and every count, ``eig_clipped`` included,
     to the single device's at every step, and every rank builds a
     metrics sink at one path, which only rank 0 writes. Phase
     14, phase 31's gloo world and phase 39's run at once, at phase 14's
     place, with phase 37's ``eigen`` run beside them (their ranks share
     the card and the host; their step times are each other's
     neighbours'), their lines printed in that order; phases 24 and 26
     run one after the other once phase 28's worlds are done, beside
     phase 27's ResNet-50 runs, their lines printed after phase 28's;
 15. main path, Transformer-XL LM: ``train_language_model.train`` with
     ``--arch transformer`` at d 1024, 18 blocks, 16 heads, MLP 4096,
     tied, synthetic vocabulary 32,768, BPTT 1024, batch 4, dropout 0,
     one fixed batch, the default ``auto`` (damped Cholesky on every
     side), factors every step, inverses every 10, 12 steps; every loss
     finite, the last three below the first three, launches factor_ema
     217 (every dense side and the embedding's G) and bucket_precond 3
     per step and nothing else, the embedding's diagonal A equal to the
     batch's id frequencies under the EMA, step times, state sizes and
     peak memory printed;
 16. the XL model under ``--kfac-approx reduce`` (tied statistics on), 3
     steps: finite losses, every block Linear resolved to reduce, the
     tied embedding's G on the stock path (factor_ema 216 per step);
     then one capture of the fixed batch: the embedding's A contribution
     with the attend site at or above the lookup's alone everywhere and
     above it on every id absent from the batch, its G different;
 17. the XL model under ``--inverse-method newton``, 3 steps, one
     firing: ns_inverse 4 (one per factor size); then each size bucket
     of the final factors through K4 (iterations; every matrix's
     residual within 2x the plain version's or 2e-5; ms) beside the
     plain version (on one matrix of the 4096 / 4097 buckets), the
     library Cholesky inverse and the bound;
 18. the Transformer CLI's own defaults (650 wide, 2 blocks, 10 heads,
     untied, dropout 0.5, nothing skipped, decoder G 10,000 on the
     synthetic 10,000 vocabulary), 3 steps: finite losses, factor_ema 27
     and bucket_precond 4 per step;
 19. distributed LM, NCCL at world size 1: phase 15's run through
     ``train_language_model.train`` inside a one-rank NCCL group,
     ``--comm-method comm-opt``, so K-FAC runs as
     ``parallel.DistributedKFAC`` with the embedding's diagonal A; every
     loss finite and falling and equal to phase 15's bit for bit (phase
     13's looser rule is for cuDNN, which the XL path does not run),
     phase 15's launches, step times beside phase 15's; then, in the same
     group, shared inputs: one capture per step into both the
     single-device ``KFAC`` and a ``DistributedKFAC`` wrapping it, 12
     steps under ``expand`` (firings at 0 and 10) and 3 under ``reduce``
     (tied statistics on), every step's factors (the embedding's diagonal
     A too) and diagonal inverses (<= 1e-5), preconditioned gradients
     (<= 1e-4; the embedding's printed on its own) and KL-clip scale
     (<= 1e-5) held to the single-device ones, both K-FAC states on the
     card at once (peak memory printed); then the ring's K/V shift over
     NCCL from rank 0 to itself, forward and backward equal bit for bit
     to the message and the incoming gradient;
 20. distributed LM, gloo: 4 ranks (subprocesses, all on ``cuda:0``) train
     the XL-width tied Transformer at 1 block (d 1024, 16 heads, MLP
     4096, vocabulary 32,768, BPTT 1024) on one sequence each of phase
     15's batch of 4, under COMM_OPT 1 x 4 ``expand``, MEM_OPT 4 x 1
     ``reduce`` and HYBRID_OPT 2 x 2 ``reduce`` + ``newton`` +
     ``symmetry_aware_comm``, 3 steps each, inverses every 2nd; rank 0
     holds every step against the single-device ``KFAC`` on the full
     batch (phase 19's tolerances; where a preconditioned gradient is
     over 1e-4, the layer's whole ``[W | b]`` matrix is held at 1e-4 of
     its largest entry to the fp64 recomputation of the distributed step,
     from the factors of its last firing and the full batch's fp64
     gradient: two fp32 Cholesky schedules part by ~1e-4 on a bias block
     alone, see PERF.md); every rank's launches equal what its assignment
     predicts (K1 on every dense side of its captures, K3 once per shape
     group its row owns, K4 once per bucket it holds a slot of), every
     rank's factors and preconditioned gradients equal bit for bit on
     each step (digests); then
     the LM CLI itself on the 4 ranks, the LSTM at PTB-medium widths,
     ``--comm-method hybrid-opt --grad-worker-fraction 0.5
     --inverse-method eigen --eigh-method jacobi``, 3 steps: every rank's
     losses identical, K5 per firing equal to the rank's buckets; step
     times print labelled as gloo through host memory;
 21. the chunked attention fold: ``chunked_causal_attention`` at (B 4,
     T 4096, H 16, D 64), blocks of 512, against ``local_causal_attention``
     on the same inputs (output <= 1e-5, q/k/v gradients <= 1e-4,
     relative to the largest plain entry), forward + backward ms and the
     peak memory of each; then phase 15's run under ``--attn-block-size
     256``, 12 steps: every loss finite and falling, steps 0-2 within 1e-4
     relative of phase 15's (the fold reorders the softmax sums), phase
     15's launches, step times and peak memory beside phase 15's;
 22. sequence parallelism, gloo: 4 ranks (subprocesses, all on
     ``cuda:0``) train phase 20's model (XL width, 1 block) with its
     attention a ring over sequence groups, each rank on its tile of
     phase 15's batch (K-FAC rank ``rank // sp`` its sequences, sequence
     index ``rank % sp`` its block of positions and ``pos_offset``):
     sp 4 x dp 1 ``expand`` (grid 1 x 1), sp 2 x dp 2 MEM_OPT ``expand`` +
     ``newton``, sp 2 x dp 2 COMM_OPT ``reduce``, 3 steps each, inverses
     every 2nd; rank 0 holds every ``expand`` step against the
     single-device ``KFAC`` on the full batch (phase 20's tolerances and
     fp64 rule), every rank's factors and preconditioned gradients equal
     every other rank's bit for bit on each step (digests), every rank's
     launches equal its assignment; then the LM CLI itself, the XL-width
     Transformer at 1 block with ``--seq-parallel 2`` (2 K-FAC ranks x
     2 sequence ranks), 3 steps: every rank's losses identical and
     finite, launches equal the assignment; step times print labelled as
     gloo through host memory. Phases 20 and 22 run at once, after phase
     21 (their eight ranks share the card and the host; their step times
     are each other's neighbours'), with phase 8's K5 edge cases beside
     them, phase 22's lines printed after phase 20's and the edge cases'
     after those;
 23. tracked config 5: ``train_imagenet_resnet.train`` with ``--model
     resnet152 --bf16-factors --inverse-method eigen``, 224 px, batch 64,
     one fixed synthetic batch, lr 0.1 (``R152_LR``: at the CLI's 0.0125
     the loss stays flat over 12 steps), factors every step, inverses
     every 10, 12 steps (firings at steps 0 and 10): every loss finite,
     the last three
     below the first three, every factor bf16 and every inverse fp32
     after the run, launches K1 157 and K2 155 per step and K3 one per
     shape bucket (printed) per step, no K4 or K5; median step ms
     (non-firing, firing), ``max_memory_allocated`` and the bytes of the
     factor and inverse state printed beside the same figures of 3 steps
     with fp32 factors; then 3 steps with ``--bf16-factors
     --bf16-inverses --bf16-precond`` (finite losses, inverses bf16), and
     the LM CLI at phase 15's XL width with the three flags, 3 steps (one
     firing): finite losses, phase 15's launches, the embedding's
     ``diag_inv`` bf16, step ms beside phase 15's;
 24. distributed with the three bf16 flags, gloo: phase 14's 4 ranks and
     ResNet-32 under COMM_OPT, MEM_OPT and HYBRID_OPT, 3 steps each; before
     each step rank 0 takes one factor step of the single-device ``KFAC``
     from the world's factors on the full batch and holds the world's new
     factors to it within 1 bf16 ulp elementwise (or 1e-5 of the factor's
     largest entry, phase 14's fp32 sum-order tolerance, where that is
     more), prints the largest gap in ulps over the run, and holds the
     preconditioned gradients and KL-clip scale against its own run at 2e-2
     of the largest reference entry (``BF16_STEP_TOL``); every rank's
     launches equal its assignment;
 25. the firing schedule at config 5: phase 23's run with
     ``--inv-pipeline-chunks 5``, 22 steps: the fired stages are
     ``cadence_flags``' (step 0 monolithic, chunks 1-4 at steps 2-8, a
     whole window 10-19), every loss finite and the last three below the
     first three, phase 23's launches per step and no K4 or K5; the chunk
     plan (items and ``dim^3`` share per chunk), each step's ms with its
     stage, the window's largest step beside phase 23's firing step and
     its mean beside phase 23's amortized step, ``KFAC.memory_usage``
     beside phase 23's state bytes; from the final state, factors frozen,
     a window of chunk firings equal to a monolithic firing bit for bit
     in every ``Q`` and ``d``; the same run with ``--inv-staleness 1``
     (chunks at phases 1, 3, 5, 7, 9, snapshots at the window heads); at
     ResNet-50 under ``newton`` with 5 chunks (11 steps): K4 one launch
     per size bucket with a matrix in the fired chunk, and the frozen
     window bit for bit; 3 config-5 steps at ``--factor-batch-fraction
     0.25`` (launches unchanged; K1 and K2 device ms of one profiled step
     beside the same step at fraction 1); phase 15's Transformer-XL with
     ``--inv-pipeline-chunks 2 --deferred-factor-reduction``, 12 steps on
     one device, then in a one-rank NCCL group: losses equal bit for bit;
 26. the firing schedule distributed, gloo: phase 14's 4 ranks and
     ResNet-32 under HYBRID_OPT 2 x 2 (``newton``) and MEM_OPT 4 x 1
     (``jacobi``) with ``inv_pipeline_chunks=2``, ``inv_staleness=1`` and
     ``deferred_factor_reduction``, inverses every 4, 9 steps; rank 0
     holds every step to the single-device ``KFAC`` with the same knobs
     firing the grid's chunk plan (factors 1e-5, gradients 1e-4, ``nu``
     1e-5); every rank's K4 / K5 launches per firing equal what its
     assignment and the plan give (``DistributedKFAC.firing_launches``),
     and every rank's factors equal the others' by digest; each rank runs
     under a timeout;
 27. checkpoint, preemption and verified resume at ResNet-50's published
     widths: the ImageNet CLI through its module entry point, each run a
     subprocess with a timeout (three on the card at once), 224 px, batch
     64, 512 synthetic images (8 steps per epoch), 2 epochs, factors every
     step, inverses every 10, ``--checkpoint-steps 4
     --checkpoint-freq 1 --deterministic``, each case in a fresh
     ``--checkpoint-dir`` under a temporary directory: an uninterrupted
     run; ``KFAC_CHAOS=preempt@5`` (exit 75, ``steps/5`` written) and its
     relaunch (resumes at epoch 0, offset 5); ``crash@9`` (exit 137,
     step bundles 4 and 8) and its relaunch (resumes at global step 8);
     ``preempt@5`` again with ``--inv-pipeline-chunks 5
     --deferred-factor-reduction --inverse-method newton`` against its
     own uninterrupted run. Every resumed run's final epoch bundle
     equals its uninterrupted run's in every tensor and scalar, file by
     file, bit for bit (``--deterministic`` makes two uninterrupted runs
     equal; ``--determinism-probe`` shows what it buys and costs); then
     the bundle's bytes, a blocking save (the manager's checksum and
     write), the checksum alone and the restore (read, verify, onto the
     card), each timed twice, each run's wall and step-save times, and
     the wall time;
 28. checkpoint and resume distributed: the CIFAR CLI on 4 gloo ranks of
     ``cuda:0`` (subprocesses, ``--dist-backend gloo``), ResNet-32 at full
     width, HYBRID_OPT 2 x 2, batch 128, 1024 synthetic images, 2 epochs
     of 8 steps,
     ``--inv-pipeline-chunks 2 --deferred-factor-reduction --eigh-method
     jacobi``, inverses every 4, ``--checkpoint-steps 3``: an
     uninterrupted run; a real SIGTERM to rank 0 alone once it has saved
     step 6, after which all four ranks drain at one global step (exit
     75) into one bundle holding every ``kfac_rank<r>.pt``, and the
     relaunch ends equal to the uninterrupted run file by file;
     ``KFAC_CHAOS=corrupt-ckpt@6,crash@7`` (exit 137), whose relaunch
     quarantines label 6 with its reason, resumes from label 3 and ends
     equal. The uninterrupted world and the two interrupted ones run at
     once, then the two relaunches; rank 0's step-save ms under the group
     are printed. The phases' launches come from each run's
     ``--launch-counts`` file and join the result line's. Phases 27 and
     28 run at once (phase 28's worlds beside phase 27's ResNet-50 runs,
     then phases 24 and 26 there), phase 28's lines printed after phase
     27's.

 29. gradient accumulation at ResNet-50 width: the ImageNet CLI
     (in process), 224 px, batch 256 as ``--grad-accum 4`` (micro-batches
     of 64), ``newton``, 12 steps on one fixed batch (firings at 0 and
     10): every loss finite, the last three below the first three, K1 55
     x 4 and K2 53 x 4 launches per factor step (the single pass's plan,
     once per micro-batch), K3 21 per step, K4 13 per firing; its peak
     device memory (allocated, above the process's baseline) beside 2-step
     ``newton`` runs at batch 64 and at batch 256 in one pass;
     then the CIFAR CLI at ResNet-32 GN, batch 512, ``--grad-accum 4``
     against ``--grad-accum 1``, 3 steps, inverses every 2nd,
     ``--eigh-method xla --deterministic``: final factors within 1e-5 and
     preconditioned gradients within 1e-4 of the largest entry, every
     loss within 1e-5 relative, K1 / K2 launches once per micro-batch;
 30. block rematerialization: ResNet-50 through the ImageNet CLI with
     ``--remat`` against without, ``--deterministic``, batches 64 and
     128, 3 steps (a firing at step 0): losses, final factors,
     preconditioned gradients and BatchNorm buffers within fp32
     tolerances (the largest gaps printed, and whether each is bit for
     bit), the BatchNorm counters equal; peak memory and the non-firing
     step ms of each;
 31. precise-BN and distribution: the ImageNet CLI at ResNet-50 (224 px,
     batch 64, one epoch of 4 steps) with ``--precise-bn-batches 4``: the
     batches are the epoch stream's first four, the evaluation's
     statistics equal the plain average of those batches' statistics
     taken by hand at the same weights (float64, unbiased variance) within
     1e-5, and the training buffers are back bit for bit after the
     evaluation; then ResNet-32 GN on 4 gloo ranks of ``cuda:0``, world
     batch 128 with ``grad_accum`` 2 (``engine.accumulate_pass``,
     ``DistributedKFAC.step(contribs=)``), comm-opt 1 x 4 and hybrid-opt
     2 x 2, 3 steps each: rank 0 holds every step to the single-device
     ``KFAC`` single pass on the full batch at phase 14's tolerances (the
     preconditioned gradients against the largest entry of all, the
     per-tensor gap printed; the loss within 1e-5), every rank's
     launches twice the single pass's K1 / K2 (the world runs beside
     phase 14, its lines printed there; ``--accum-only`` runs it here).
     Phases 29-31 print their seconds.
 32. grouped / depthwise convs: MobileNetV1 at the JAX package's
     depthwise workload (width 1.0, 176 px, batch 64, damping 0.003, lr
     0.1, momentum 0.9, factors every step, inverses every 10, ``auto``),
     12 ``KFAC.step`` steps on one fixed synthetic batch in fp32: 13
     ``conv2d_grouped`` layers registered (28 in all, only BatchNorms
     declined), every loss finite, the last three below the first three,
     launches K1 16, K2 14, K3 11 per step and no K4 / K5 (the grouped
     layers launch no kernel); the last step's grouped A and G stacks, the
     contribution and the stored EMA, within 1e-5 of a float64 per-group
     covariance of the same captures taken with ``F.unfold``; non-firing
     and firing step ms and the peak memory; then a one-rank NCCL
     ``DistributedKFAC`` (COMM_OPT) for 3 shared-input steps, held to the
     single device as phase 13 (factors 1e-5, preconditioned gradients
     1e-4, ``nu`` 1e-5);
 33. ViT-S/16 through ``train_imagenet_resnet.train({'model':
     'vit_small', ...})``, 224 px, batch 64, one fixed synthetic batch,
     lr 0.1 with no warm-up, damping 0.003, factors every step, inverses
     every 10: 12 steps under ``auto`` (firings at 0 and 10), then 3
     under ``--kfac-approx reduce`` (the patch conv's reduced rows through
     K1); every loss finite and falling, launches per step K1 147 (148
     under reduce), K2 1 (0), K3 5, no K4 / K5, the K3 buckets in the
     forms phase 3 times; non-firing and firing step ms.
     Phases 32-33 print their seconds.
 34. fp16: ResNet-50 through ``train_imagenet_resnet.train`` with
     ``--fp16`` (fp16 compute, fp32 parameters; the dynamic loss scale
     from 2**15), 224 px, batch 64, ``auto``, one fixed synthetic batch,
     12 steps (firings at 0 and 10): every loss finite, the last three
     below the first three, the loss scale of every step printed, the
     parameters fp32, launches K1 55, K2 53, K3 21 per step that ran its
     K-FAC step (an overflow step launches nothing) and no K4 / K5;
     non-firing and firing step ms and the peak memory beside phases 6
     and 7's fp32 figures; then the same under ``KFAC_CHAOS=nan-batch@5``
     over 8 steps: step 5 overflows besides the steps the clean run's
     schedule skipped (at 2**15 ResNet-50's first step overflows and the
     scale settles at 2**14), the parameters, the SGD
     momentum, every ``kfac_state`` tensor and the BatchNorm buffers are
     equal bit for bit before and after it (``kfac_state['step']``
     advances), the scale halves and every later loss is finite; then
     ``KFAC(nonfinite_guard=True)``, on phase 3's fp16 model, batch and
     scale, given a poisoned capture after a clean one keeps every
     factor bit for bit, and without the guard the factors go
     non-finite;
 35. the Transformer-XL LM (phase 15's width, all 18 blocks) through
     ``train_language_model.train`` with ``--fp16``, 6 steps, one firing:
     finite, falling losses, the scale per step, phase 15's launches per
     step, non-firing step ms and peak beside phase 15's;
 36. bf16 activations (the JAX benches' default): MobileNetV1 (phase 32's
     settings) and ViT-S/16 (phase 33's) built at ``torch.bfloat16``, 6
     ``engine.train_step`` steps each on one fixed batch: finite, falling
     losses, phases 32-33's launches per step, step ms and peak beside
     theirs.
     Phases 34-36 print their seconds.
 37. the randomized low-rank inverse at XL: phase 15's run with
     ``--inv-lowrank-rank 256`` (threshold 2048: mlp_in's G and mlp_out's
     A take rank-256 truncated eigenpairs), 12 steps under ``auto``
     (firings at 0 and 10): the two layers mixed, their truncated side
     baked, phase 15's launches per step (every bucket through K3's
     baked path); non-firing and step-10 firing ms, the peak and the
     inverse bytes beside phase 15's; block 0's mlp_in G decomposed from
     its carried basis on the card and on the CPU, the damped operators
     ``I/l + Q diag(1/(d + l) - 1/l) Q^T`` within 1e-4 of the CPU's
     largest entry; and 6 steps under ``--inverse-method eigen`` (run
     beside phase 14's worlds, above): K3 on the (1024, 1025) eigen
     bucket alone, the two truncated buckets by stock torch;
 38. config 5 with ``--inv-lowrank-rank 256``: phase 23's ResNet-152
     run, 12 steps: the buckets with a side of 2048 or more by stock
     torch, the others through K3 (launches K1 157, K2 155 and K3 those
     buckets per step), losses finite and falling; the step-10 firing,
     the window mean and the inverse bytes beside phase 23's;
 39. multi-slice, in the wave of phase 14 (above): 4 gloo ranks on the
     card as 2 slices x 2, ResNet-32 as phase 14 runs it, 5 steps with
     inverses every 2 (``eigen``, the library eigh): the hierarchical
     reduce against the flat one on the same layout, every rank's factors
     at every window head, gradients and ``nu`` at every step within
     phase 14's tolerances; then a low-rank case on 2 slices (threshold
     512, rank 32: the 576-wide A sides engage), rank 0 against the
     single-device ``KFAC`` (factors 1e-5, gradients by relative norm
     5e-3, ``nu`` 1e-3); every rank's launches equal its assignment (K3
     on the buckets without a truncated side).
 40. the on-device K-FAC metrics and their stream: phase 7's ResNet-50
     run through ``train_imagenet_resnet.train`` (224 px, batch 64,
     ``auto``, one fixed batch, 12 steps, firings at 0 and 10,
     ``--deterministic``), once with ``--kfac-metrics PATH
     --metrics-interval 1 --health-action warn --log-dir DIR`` and once
     without, the launch counts reset before each run and read after it
     (phase 7's per step): the two runs' losses and final parameters
     equal bit for bit; the stream, read by the port's ``report --json``:
     12 step records, their 12 epoch records, 2 meta records,
     ``kfac/factor_updates`` 1..12, ``kfac/inv_updates`` stepping at 0
     and 10, ``nu`` <= 1, every norm finite, the 21 bucket keys the run's
     ``KFAC`` preconditions, no health event; the median non-firing step
     with the metrics on and off and their difference, the device kernels
     one step adds with the metrics on (profiler, on the run's final
     state), and the sink's host ms to enqueue a record and to drain 12;
 41. the rest of observability: phase 40's ResNet-50 run on two fixed
     batches (12 steps, 2 per epoch) with ``--kfac-metrics
     --metrics-interval 1 --memory-interval 4 --profile-dir DIR`` and with
     ``--kfac-metrics`` alone: losses and parameters bit for bit, phase
     7's launches per step; the first epoch's Chrome trace holds the
     ``kfac/*`` scopes the step reaches and every K1, K2 and K3 launch
     inside a scope of its stage; device ms per scope of the firing and
     the plain step; the memory records' peak within 1 % of
     ``torch.cuda.max_memory_allocated()`` and their footprint the state's
     tensor bytes; the epoch records' trace table; the port's ``gate``
     passing against the stream's own baseline and failing against one
     with a tolerance broken; the profiler's cost on a step and a memory
     record's host cost;
 42. self-healing on ResNet-32 at full width through the CIFAR CLI
     (``--deterministic``): ``KFAC_CHAOS=diverge@6 --selfheal`` escalates
     the damping and rolls back in the process to the newest verified,
     finite step bundle before the fault, then finishes with finite,
     falling losses (the ``gate`` counts one rollback);
     ``corrupt-factor@3`` quarantines the ``conv1`` bucket, every gated
     step launches K3 and is held against the stock path with the same
     gates (1e-4), and the bucket is re-admitted after the next firing;
     ``--selfheal`` without a fault moves ``nu`` by at most 1e-6; unarmed,
     the run equals the one without the engine's observers bit for bit,
     with phase 5's launches per step;
 43. straggler shards: 4 gloo ranks of the card (2 slices x 2) run the
     CIFAR CLI at ResNet-32 with ``--num-slices 2 --hierarchical-reduce
     --kfac-metrics --straggler-shards --straggler-sample-every 2``: one
     shard per rank, the barrier probe's waits on the even steps only,
     the window heads ``dcn_reduce``, the shards read by ``merge_shards``
     and ``straggler_summary``; then ``DistributedKFAC.precondition(
     gates=)`` on the run's state under three gate sets, rank 0 against the
     single-device ``KFAC`` within phase 14's tolerances and each gated
     layer its raw gradient times ``nu``, exactly.
     The script ends with every phase header's wall time, largest first.

``--quick`` builds with ``-Xptxas -v`` and runs only the correctness
checks of phases 3, 4 and 8 (a first call after a kernel change).
``--profile`` adds a torch.profiler pass over steady ResNet-32,
ResNet-50 (``newton``), LSTM (``jacobi``), Transformer-XL (``auto``) and
config-5 steps (ResNet-152 ``eigen``, bf16 and fp32 factors), and the
half-precision paths beside their fp32 twins (ResNet-50 ``--fp16``,
ViT-S/16 at fp32 and bf16, the XL LM ``--fp16``) (device
time by kernel category, the device's busy share; it fails
if the ResNet-50 steps show no K2 time or the XL steps no K1 time). Details of every case go to
``chiprun_out/chip_smoke.json`` next to this script. ``--resume-only``
builds and runs phases 27-28 alone (no result line;
``chiprun_out/chip_smoke_resume.json``); ``--accum-only`` builds and runs
phases 29-31 alone (``chiprun_out/chip_smoke_accum.json``);
``--models-only`` builds and runs phase 3's ViT-S and MobileNetV1 cases
and phases 32-33 alone (``chiprun_out/chip_smoke_models.json``);
``--fp16-only`` builds and runs phase 3's ResNet-50 ``--fp16`` cases and
phases 34-36 alone (``chiprun_out/chip_smoke_fp16.json``);
``--lowrank-only`` builds and runs phases 37-39 alone
(``chiprun_out/chip_smoke_lowrank.json``); ``--metrics-only`` builds and
runs phase 40 and phase 14 alone (``chiprun_out/chip_smoke_metrics.json``);
``--observability-only`` builds and runs phases 41-43 alone
(``chiprun_out/chip_smoke_observability.json``);
``--determinism-probe`` (alone
or before ``--resume-only``'s phases) runs phase 27's uninterrupted
ResNet-50 twice without ``--deterministic`` and compares the final
bundles, then times phase 6's steps with cuDNN's deterministic
algorithms off, on, on and off.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import platform
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense TF32 on the tensor cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
# What each kernel's operations run on, for its bound: K1-K4 take each
# fp32 product as three TF32 products (3xTF32), K5 is fp32 FMAs.
TC_RATE = 'tf32 tensor cores, 3 per fp32 product (494.7 TFLOP/s)'
TC_KERNELS = ('factor_ema', 'patch_cov', 'bucket_precond', 'ns_inverse')
BOUND_RATE = dict.fromkeys(TC_KERNELS, TC_RATE)
FP32_RATE = 'fp32 CUDA cores (67 TFLOP/s)'
# fp32 FLOPs per second of each kernel's bound (phase 3).
OPS_PEAK = {'factor_ema': PEAK_TF32_FLOPS / 3,
            'patch_cov': PEAK_TF32_FLOPS / 3,
            'bucket_precond': PEAK_TF32_FLOPS / 3}
PEAK_BYTES = 3.35e12
# Dense bf16 tensor cores: the bound of products of bf16-rounded operands
# (K1 and K2 with bf16 multiplicands, tracked config 5).
PEAK_BF16_FLOPS = 989.4e12
# One bf16 ulp of the largest entry, relative to it (at most 2^-7): a
# bf16-stored result held against its plain version.
BF16_ULP = 2.0 ** -7
TOL_FP32 = {'factor_ema': 1e-5, 'patch_cov': 1e-5, 'bucket_precond': 1e-4}
TOL_BF16 = 1e-2
STEPS = 30
EXPECTED_PER_STEP = {'factor_ema': 33, 'patch_cov': 31, 'bucket_precond': 7,
                     'ns_inverse': 0}
# ResNet-50 path: per factor step, per step, per firing.
R50_STEPS, R50_FIRE_EVERY, R50_BATCH = 12, 10, 64
R50_PER_STEP = {'factor_ema': 55, 'patch_cov': 53, 'bucket_precond': 21}
R50_PER_FIRING = 13
# The CLI's base lr; the KL clip bounds each step, so the loss falls on
# the fixed batch within 12 steps at this lr.
R50_LR = 0.0125
NS_TOL = 1e-4          # relative Frobenius error of K4, n <= 1024
NS_EDGE_SIZES = (1, 2, 65, 100)
# K5: the LSTM LM's gate buckets (A 651, G 650; 16 gates each) and
# ResNet-32's nine factor sizes, (n, matrices); one launch each per firing.
LSTM_JACOBI_BUCKETS = ((651, 16), (650, 16))
R32_JACOBI_BUCKETS = ((27, 1), (144, 11), (288, 10), (576, 9), (65, 1),
                      (16, 11), (32, 10), (64, 10), (10, 1))
JACOBI_EDGE_SIZES = (1, 2, 3, 64, 65)
JACOBI_DAMPING = 0.003
# LSTM LM path: steps, inverse cadence, launches per step and per firing.
LM_STEPS, LM_FIRE_EVERY = 12, 10
LM_PER_STEP = {'factor_ema': 0, 'patch_cov': 0, 'bucket_precond': 1,
               'ns_inverse': 0}
LM_JACOBI_PER_FIRING = 2
R32_JACOBI_STEPS, R32_JACOBI_PER_FIRING = 11, 9
R32_PER_STEP_K1, R32_PER_STEP_K2 = 33, 31
# Phase 13 against phase 6. cuDNN's backward kernels make the ResNet-50
# run chaotic at this lr: two runs of phase 6 itself drift apart from step
# 3 (1.4e-2 relative by step 11 on the H100), so steps 0-2 are held at
# 1e-3 and the mean of the last three within 5e-2.
R50_NCCL_HELD, R50_NCCL_FINAL_TOL = 3, 5e-2
# Every step of phase 13's shared-input check (the same captures and
# gradients into the single-device KFAC and DistributedKFAC) and of phase
# 14's gloo ranks is held to these, relative to the largest reference entry.
STEP_TOL = {'factors': 1e-5, 'precond': 1e-4, 'nu': 1e-5}
# Phase 14's on-device metrics against the single-device KFAC's, at the
# same limits: nu and the gradient norm as nu, the preconditioned and
# bucket norms as the preconditioned gradients.
METRIC_TOL = {'metrics_nu': 1e-5, 'metrics_norms': 1e-4}
# Transformer-XL large (tracked config 4; benchmarks/flagship_lm.py's
# shape): d 1024, 18 blocks, 16 heads, MLP 4096, vocabulary 32768, BPTT
# 1024, batch 4, tied embedding, fp32. Per expand step K1 runs every dense
# side (18 blocks x 6 Linears x 2) plus the untied-statistics embedding's
# G; K3 the three baked shape buckets (G, A): 72 x (1024, 1025) for
# q/k/v/o, 18 x (4096, 1025) for mlp_in, 18 x (1024, 4097) for mlp_out.
XL_D, XL_LAYERS, XL_HEADS, XL_VOCAB = 1024, 18, 16, 32768
XL_BPTT, XL_BATCH = 1024, 4
XL_TOKENS = XL_BPTT * XL_BATCH
XL_STEPS, XL_FIRE_EVERY = 12, 10
XL_K1_CASES = (   # (rows, d, bias, launches per step)
    (XL_TOKENS, XL_D, True, 5 * XL_LAYERS),           # q, k, v, o, mlp_in A
    (XL_TOKENS, XL_D, False, 5 * XL_LAYERS + 1),      # ... G and embed G
    (XL_TOKENS, 4 * XL_D, True, XL_LAYERS),           # mlp_out A
    (XL_TOKENS, 4 * XL_D, False, XL_LAYERS))          # mlp_in G
XL_K3_BUCKETS = (((XL_D, XL_D + 1), 4 * XL_LAYERS),
                 ((4 * XL_D, XL_D + 1), XL_LAYERS),
                 ((XL_D, 4 * XL_D + 1), XL_LAYERS))
XL_PER_STEP = {'factor_ema': sum(c[3] for c in XL_K1_CASES),
               'patch_cov': 0, 'bucket_precond': len(XL_K3_BUCKETS),
               'ns_inverse': 0, 'jacobi_eigh': 0}
# Under --kfac-approx reduce the tied embedding's G (lookup plus attend
# terms) leaves K1 for the stock path.
XL_REDUCE_PER_STEP = {**XL_PER_STEP,
                      'factor_ema': XL_PER_STEP['factor_ema'] - 1}
XL_REDUCE_STEPS, XL_NEWTON_STEPS = 3, 3
# Under --inverse-method newton, one K4 launch per factor size per firing.
XL_NS_SIZES = (XL_D, XL_D + 1, 4 * XL_D, 4 * XL_D + 1)
# The plain Newton--Schulz iteration runs on one matrix of each bucket of
# this size or more (in fp32 it can stall to the 100-iteration cap).
XL_NS_PLAIN_ONE_FROM = 4 * XL_D
# The Transformer CLI's own defaults: 650 wide, 2 blocks, 10 heads,
# untied, BPTT 35, batch 20, synthetic vocabulary 10,000, nothing skipped:
# K1 on 2 x 6 x 2 block sides + the embedding's G + the decoder's A and G;
# K3 on four buckets, (650, 651) x 8, (2600, 651) x 2, (650, 2601) x 2 and
# the decoder's (10000, 651).
TLM_DEFAULT_STEPS = 3
TLM_DEFAULT_PER_STEP = {'factor_ema': 27, 'patch_cov': 0,
                        'bucket_precond': 4, 'ns_inverse': 0,
                        'jacobi_eigh': 0}
# (n, matrices) of each ResNet-50 factor size bucket: one K4 launch each
# per firing under 'newton'.
# Phase 19's shared-input check runs the XL model at XL_SHARED_LAYERS
# blocks, 12 expand steps (firings at 0 and 10) and 3 reduce steps. Its
# depth is cut to 6 of the 18 blocks for the script's time budget; phase
# 19's own run and phase 25's NCCL run keep all 18.
XL_SHARED_LAYERS = 6
XL_SHARED_EXPAND_STEPS, XL_SHARED_REDUCE_STEPS = XL_STEPS, 3
# Phase 20: the XL width at 1 block on 4 gloo ranks (one sequence each),
# 3 steps per case, inverses every 2nd. The depth is cut to one block for
# the script's time budget: the gloo phases 20 and 22 move every block's
# statistics through host memory.
LM_GLOO_LAYERS, LM_GLOO_STEPS, LM_GLOO_INV_FREQ = 1, 3, 2
# Phase 21: the chunked fold alone at a long sequence (batch 4, 4096
# tokens, 16 heads of 64), blocks of 512, then phase 15's run in blocks of
# 256; its losses held to phase 15's on the first three steps.
ATTN_SHAPE, ATTN_BLOCK, XL_ATTN_BLOCK = (4, 4096, 16, 64), 512, 256
CHUNKED_OUT_TOL, CHUNKED_GRAD_TOL = 1e-5, 1e-4
XL_CHUNKED_LOSS_TOL, XL_CHUNKED_HELD = 1e-4, 3
# Phase 22: phase 20's width on 4 gloo ranks, the sequence sharded:
# (name, seq_parallel, comm_method, fraction, grid, KFAC knobs); then the
# LM CLI with --seq-parallel SEQ_CLI_SP.
SEQ_GLOO_CASES = (
    ('sp4_expand', 4, 'comm-opt', 0.0, (1, 1), {'kfac_approx': 'expand'}),
    ('sp2_mem_opt_expand_newton', 2, 'mem-opt', 0.0, (2, 1),
     {'kfac_approx': 'expand', 'inverse_method': 'newton'}),
    ('sp2_comm_opt_reduce', 2, 'comm-opt', 0.0, (1, 2),
     {'kfac_approx': 'reduce'}))
SEQ_CLI_SP = 2
# Phase 23: tracked config 5 (BASELINE.md:35; the JAX package's config at
# benchmarks/flagship_resnet50.py:513-530): ResNet-152 at 224 px, batch 64,
# --bf16-factors --inverse-method eigen, factors every step, inverses every
# 10, 12 steps on one fixed batch. Per step K1 runs every conv G and both
# fc sides (157), K2 every conv A (155), K3 every (eigen) shape bucket.
R152_STEPS, R152_SHORT_STEPS = 12, 3
R152_PER_STEP = {'factor_ema': 157, 'patch_cov': 155}
# At the CLI's lr 0.0125 ResNet-152's loss on the fixed batch fell 7.812
# -> 7.742 at step 1 and then wandered within +-0.04 (the last three
# 0.004 below the first three, under the run-to-run spread): the KL-clipped
# steps are too small for the deeper net in 12 steps. At 0.1 it falls.
R152_LR = 0.1
BF16_FLAGS = {'bf16_factors': True, 'bf16_inverses': True,
              'bf16_precond': True}
# Phase 24: phase 14's ResNet-32 ranks with the three flags. Rank 0 holds
# each step's preconditioned gradients and KL-clip scale against the
# single-device KFAC at 2e-2 of the largest reference entry: both read
# bf16 inverses with bf16 operands, computed from factors at most one
# bf16 ulp (2^-8 of a value) apart, and a product of three rounded
# operands moves by about three of those.
BF16_STEP_TOL = {'precond': 2e-2, 'nu': 2e-2}
R50_NS_BUCKETS = ((64, 12), (128, 12), (147, 1), (256, 26), (512, 19),
                  (576, 3), (1000, 1), (1024, 14), (1152, 4), (2048, 6),
                  (2049, 1), (2304, 6), (4608, 3))

# Phase 32: MobileNetV1 at the JAX package's depthwise workload
# (benchmarks/depthwise_bench.py:128-150): width 1.0, 176 px, batch 64,
# damping 0.003, K-FAC and SGD lr 0.1 (momentum 0.9), factors every step,
# inverses every 10, 'auto', 12 steps on one fixed synthetic batch, fp32
# (the bench defaults to bf16 activations; the port has no model dtype).
# Per step K1 runs the stem's and the 13 pointwise convs' G and the fc's A
# and G (16), K2 their A (14), K3 one launch per dense gradient shape (the
# stem (32, 27), the pointwise (64, 32), (128, 64), (128, 128),
# (256, 128), (256, 256), (512, 256), (512, 512) x 5, (1024, 512),
# (1024, 1024) and the fc (1000, 1025): 11); the 13 depthwise convs
# (conv2d_grouped) launch no kernel: stock torch factors, batched damped
# Cholesky, G_inv V A_inv over their block stacks.
MB_PX, MB_BATCH, MB_STEPS, MB_FIRE_EVERY = 176, 64, 12, 10
MB_LR, MB_DAMPING, MB_GROUPED = 0.1, 0.003, 13
MB_PER_STEP = {'factor_ema': 16, 'patch_cov': 14, 'bucket_precond': 11,
               'ns_inverse': 0, 'jacobi_eigh': 0}
MB_NCCL_STEPS = 3
# Phase 32's per-group float64 check of the final grouped factors.
MB_GROUPED_TOL = 1e-5
# Phase 33: ViT-S/16 (benchmarks/vit_bench.py:133-148; SGD lr 0.1,
# momentum 0.9, K-FAC damping 0.003) through the ImageNet CLI at 224 px,
# batch 64, one fixed synthetic batch, factors every step, inverses every
# 10, no warm-up. Per step under 'expand' K1 runs the A and G of the 12 x
# 6 block Linears (rows (64 * 197, d)) and of the head (rows (64, d)) and
# the patch conv's G (147); K2 the patch conv's A (1); under 'reduce' the
# patch conv's reduced A and G rows go to K1 as well (148 K1, no K2). K3
# runs the five gradient shapes, in the form 'auto' gives them: q, k, v,
# o eigen (A 385, G 384); mlp_in (G 1536), mlp_out (A 1537), the head (G
# 1000) and the patch conv (A 769) baked.
VIT_BATCH, VIT_PX, VIT_STEPS, VIT_FIRE_EVERY = 64, 224, 12, 10
VIT_TOKENS, VIT_D, VIT_LAYERS = 64 * 197, 384, 12
VIT_REDUCE_STEPS = 3
VIT_K1_CASES = (   # (rows, d, bias, launches per step)
    (VIT_TOKENS, VIT_D, True, 5 * VIT_LAYERS),      # q, k, v, o, mlp_in A
    (VIT_TOKENS, VIT_D, False, 5 * VIT_LAYERS),     # q, k, v, o, mlp_out G
    (VIT_TOKENS, 4 * VIT_D, True, VIT_LAYERS),      # mlp_out A
    (VIT_TOKENS, 4 * VIT_D, False, VIT_LAYERS),     # mlp_in G
    (VIT_BATCH, VIT_D, True, 1),                    # head A
    (VIT_BATCH, 1000, False, 1))                    # head G
# (gradient shape (G, A), layers, form) of the K3 buckets.
VIT_K3_BUCKETS = (((VIT_D, VIT_D + 1), 4 * VIT_LAYERS, 'eigen'),
                  ((4 * VIT_D, VIT_D + 1), VIT_LAYERS, 'baked'),
                  ((VIT_D, 4 * VIT_D + 1), VIT_LAYERS, 'baked'),
                  ((1000, VIT_D + 1), 1, 'baked'),
                  ((VIT_D, 3 * 16 * 16 + 1), 1, 'baked'))
VIT_PER_STEP = {'factor_ema': sum(c[3] for c in VIT_K1_CASES) + 1,
                'patch_cov': 1, 'bucket_precond': len(VIT_K3_BUCKETS),
                'ns_inverse': 0, 'jacobi_eigh': 0}
VIT_REDUCE_PER_STEP = {**VIT_PER_STEP,
                       'factor_ema': VIT_PER_STEP['factor_ema'] + 1,
                       'patch_cov': 0}

# Phases 34-36: ResNet-50 under --fp16 (the reference's ImageNet
# recipe) through the ImageNet CLI as phase 6 but 'auto', firings at 0 and
# 10, the dynamic loss scale starting at 2**15; the same with the nan-batch
# fault at step 5 over 8 steps; the Transformer-XL LM under --fp16 at
# FP16_XL_LAYERS blocks (the depth the script's time allows; phase 15 keeps
# 18), 6 steps, one firing; MobileNetV1 and ViT-S/16 at bf16 activations
# (the JAX benches' default) with phases 32-33's settings, 6 steps each.
FP16_STEPS, FP16_INIT_SCALE = 12, 2.0 ** 15
FP16_CHAOS_STEP, FP16_CHAOS_STEPS = 5, 8
FP16_XL_LAYERS, FP16_XL_STEPS = 18, 6
BF16_MODEL_STEPS = 6

# Phase 3's cases at the shapes of phases 32-33: (header, key, keywords of
# check_kernels).
_MODEL_KERNEL_CHECKS = (
    (f'== kernels K1-K3 vs plain versions: ViT-S/16 shapes ({VIT_PX} px, '
     f'batch {VIT_BATCH})', 'vit_small', {'vit': True}),
    (f'== kernels K1-K3 vs plain versions: MobileNetV1 shapes ({MB_PX} px, '
     f'batch {MB_BATCH})', 'mobilenet_v1', {'mobilenet': True}))

_T0 = time.perf_counter()


#: ``(header, seconds since the start)`` of every phase header logged.
HEADERS: list = []


#: Where a thread's :func:`log` lines go instead of stdout (:func:`at_once`).
_LOG_BUFFER = threading.local()


def log(msg: str) -> None:
    """Print a line; a phase's header (``== ...``) with the seconds since
    the script started (kept in ``HEADERS``). A call running under
    :func:`at_once` keeps its lines instead."""
    buffered = getattr(_LOG_BUFFER, 'lines', None)
    if buffered is not None:
        buffered.append(msg)
        return
    if msg.startswith('=='):
        now = time.perf_counter() - _T0
        HEADERS.append((msg, now))
        msg = f'{msg} [{now:.1f} s]'
    print(msg, flush=True)


def _cpu_model() -> str:
    """The host CPU's model name (hosts differ in speed from call to
    call; the script's wall time is read beside it)."""
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or 'unknown CPU'


def phase_walls() -> list:
    """``[(header, wall s)]``: each logged phase header with the seconds
    until the next one (the last until now), largest first."""
    marks = HEADERS + [('', time.perf_counter() - _T0)]
    walls = [(h[:72], round(t1 - t0, 1))
             for (h, t0), (_, t1) in zip(marks, marks[1:])]
    return sorted(walls, key=lambda w: -w[1])


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, trials: int = 5, warmup: int = 3) -> float:
    """Median over ``trials`` of the mean ms per call of ``reps`` calls,
    CUDA events around each trial, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


# ---------------------------------------------------------------------------
# Cases: (label, per-step count on the main path or 0 for an edge case,
# builder of (kernel_fn(bf16), plain_fn(bf16), library_fn, nbytes, flops))
# ---------------------------------------------------------------------------

def factor_ema_cases(gen, dev, resnet50=None, xl=False,
                     storage_bf16=False, vit=False, mobilenet=None):
    """K1's cases; ``storage_bf16``: the running factor ``old`` (and so the
    result) in bf16, K1's bf16-storage mode, each case also held bit for
    bit against the widen, fp32 launch, round sequence (``kern.widened``)
    and timed beside it."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K

    def case(shape, has_bias, channels_last=False, storage_bf16=False):
        x = torch.randn(shape, generator=gen, device=dev)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        if x.ndim == 4:
            b, c, h, w = x.shape
            rows, d_in = b * h * w, c
            scale = float(rows) * (h * w) ** 2
        else:
            rows, d_in = x.shape
            scale = float(rows)
        n = d_in + int(has_bias)
        m = torch.randn((n, n), generator=gen, device=dev) * 0.01
        old = (torch.eye(n, device=dev) + m + m.T).contiguous()
        if storage_bf16:
            old = old.bfloat16()
        x2 = K._gram_rows(x).contiguous()
        old_in = old[:d_in, :d_in].float().contiguous()   # no bias row
        decay = 0.95

        # Checked in both forms: with the EMA as the main path runs it,
        # and contraction-only, where the Gram is not swamped by ``old``
        # (conv G's 1/(rows*spatial^2) scale makes the blended term tiny).
        def kern(bf16, both=True):
            cdt = torch.bfloat16 if bf16 else None
            ema = K.factor_ema(x, old, decay, scale=scale,
                               has_bias=has_bias, compute_dtype=cdt)
            if not both:
                return ema
            return ema, K.factor_ema(x, None, 0.0, scale=scale,
                                     has_bias=has_bias, compute_dtype=cdt)

        def plain(bf16, both=True):
            ema = K.factor_ema_plain(x, old, decay, scale=scale,
                                     has_bias=has_bias, bf16=bf16)
            if not both:
                return ema
            return ema, K.factor_ema_plain(x, None, 0.0, scale=scale,
                                           has_bias=has_bias, bf16=bf16)

        def library():
            return torch.addmm(old_in, x2.T, x2, beta=decay,
                               alpha=(1 - decay) / scale)

        # A path that blends K1's contraction in torch (DistributedKFAC,
        # after its all_reduce) has K1's fused bits only through
        # kernels.ema_blend: checked bit for bit in phase 3.
        kern.blend = lambda f: K.ema_blend(old, f, decay)
        kern.plan = K.factor_ema_plan(x.shape, x.stride(), has_bias,
                                      K._sm_count(x.device.index or 0),
                                      aligned=x.data_ptr() % 16 == 0)
        if storage_bf16:
            # What the bf16-storage mode replaces: widen the stored
            # factor, blend with an fp32 launch, round the result.
            kern.widened = lambda bf16: K.factor_ema(
                x, old.float(), decay, scale=scale, has_bias=has_bias,
                compute_dtype=torch.bfloat16 if bf16 else None).bfloat16()
        nbytes = 4 * rows * d_in + 2 * old.element_size() * n * n
        return kern, plain, library, nbytes, rows * d_in * (d_in + 1)

    if mobilenet:
        # The MobileNetV1 step's cases (phase 32): the stem's and the
        # pointwise convs' G and the fc's A and G (the depthwise convs
        # launch no kernel).
        fc_in, fc_out = mobilenet['fc']
        return [(f'mobilenet conv G ({MB_BATCH},{c},{h},{w})', count,
                 lambda c=c, h=h, w=w: case((MB_BATCH, c, h, w), False))
                for (c, h, w), count in mobilenet['conv_g']] + [
            (f'mobilenet linear A ({MB_BATCH},{fc_in})+bias', 1,
             lambda: case((MB_BATCH, fc_in), True)),
            (f'mobilenet linear G ({MB_BATCH},{fc_out})', 1,
             lambda: case((MB_BATCH, fc_out), False))]
    if vit:
        # The ViT-S/16 step's cases (phase 33, 'expand'): every Linear's
        # A and G and the patch conv's G.
        return [(f'vit ({rows},{d}){"+bias" if bias else ""}', count,
                 lambda rows=rows, d=d, bias=bias: case((rows, d), bias))
                for rows, d, bias, count in VIT_K1_CASES] + [
            (f'vit patch conv G ({VIT_BATCH},{VIT_D},14,14)', 1,
             lambda: case((VIT_BATCH, VIT_D, 14, 14), False))]
    if xl:
        # The XL step's cases, then one in bf16-storage mode (untimed on
        # the main path: phase 15 keeps fp32 factors).
        rows, d, bias, _ = XL_K1_CASES[0]
        return [(f'xl ({rows},{d}){"+bias" if bias else ""}', count,
                 lambda rows=rows, d=d, bias=bias: case((rows, d), bias))
                for rows, d, bias, count in XL_K1_CASES] + [
            (f'xl ({rows},{d})+bias bf16 storage', 0,
             lambda: case((rows, d), bias, storage_bf16=True))]
    if resnet50:
        fc_in, fc_out = resnet50['fc']
        tag = ' bf16 storage' if storage_bf16 else ''
        return [(f'conv G ({R50_BATCH},{c},{h},{w}){tag}', count,
                 lambda c=c, h=h, w=w: case((R50_BATCH, c, h, w), False,
                                            storage_bf16=storage_bf16))
                for (c, h, w), count in resnet50['conv_g']] + [
            (f'linear A ({R50_BATCH},{fc_in})+bias{tag}', 1,
             lambda: case((R50_BATCH, fc_in), True,
                          storage_bf16=storage_bf16)),
            (f'linear G ({R50_BATCH},{fc_out}){tag}', 1,
             lambda: case((R50_BATCH, fc_out), False,
                          storage_bf16=storage_bf16))]
    return [
        ('conv G (128,16,32,32)', 11, lambda: case((128, 16, 32, 32), False)),
        ('conv G (128,32,16,16)', 10, lambda: case((128, 32, 16, 16), False)),
        ('conv G (128,64,8,8)', 10, lambda: case((128, 64, 8, 8), False)),
        ('linear A (128,64)+bias', 1, lambda: case((128, 64), True)),
        ('linear G (128,10)', 1, lambda: case((128, 10), False)),
        ('ragged (1000,65)+bias', 0, lambda: case((1000, 65), True)),
        ('ragged (37,5)', 0, lambda: case((37, 5), False)),
        ('channels-last conv G (8,24,7,7)', 0,
         lambda: case((8, 24, 7, 7), False, channels_last=True)),
        # One per staging path the plan can choose, d past one tile:
        # 7 x 7 (4-byte K-major), channels-last and dense (4-byte feature
        # gathers; rows not a multiple of 32), w == 1 (16-byte K-major).
        ('7x7 conv G (16,200,7,7)', 0, lambda: case((16, 200, 7, 7), False)),
        ('channels-last conv G (8,160,14,14)', 0,
         lambda: case((8, 160, 14, 14), False, channels_last=True)),
        ('ragged (1000,200)+bias', 0, lambda: case((1000, 200), True)),
        ('w=1 conv G (16,136,12,1)', 0,
         lambda: case((16, 136, 12, 1), False)),
    ]


def patch_cov_cases(gen, dev, resnet50=None, vit=False,
                    mobilenet=None):
    import torch
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K

    def case(shape, stride, padding, has_bias=False, channels_last=False,
             k=(3, 3)):
        x = torch.randn(shape, generator=gen, device=dev)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        (pads, oh, ow) = K.conv_out_geometry(x.shape, k, stride, padding)
        (ph_lo, ph_hi), (pw_lo, pw_hi) = pads
        b, c = shape[:2]
        rows, d = b * oh * ow, c * k[0] * k[1]
        n = d + int(has_bias)

        # One output; a 1-tuple for the checks, the tensor when timed.
        def kern(bf16, both=True):
            out = K.patch_cov(x, k, stride, padding, has_bias,
                              compute_dtype=torch.bfloat16 if bf16
                              else None)
            return (out,) if both else out

        def plain(bf16, both=True):
            out = K.patch_cov_plain(x, k, stride, padding, has_bias,
                                    bf16=bf16)
            return (out,) if both else out

        def library():
            # im2col rows in the (c, kh, kw) basis, then one GEMM.
            xp = F.pad(x, (pw_lo, pw_hi, ph_lo, ph_hi))
            p = F.unfold(xp, k, stride=stride).transpose(1, 2).reshape(-1, d)
            return p.T @ p

        kern.plan = K.patch_cov_plan(x.shape, x.stride(), k, stride, pads,
                                     has_bias,
                                     K._sm_count(x.device.index or 0),
                                     aligned=x.data_ptr() % 16 == 0)
        nbytes = 4 * (x.numel() + n * n)
        return kern, plain, library, nbytes, rows * d * (d + 1)

    if vit:
        # The ViT-S/16 patch embedding: kernel = stride = 16, no padding,
        # 768 features plus the bias (phase 33, 'expand').
        return [(f'vit patch embed D=769 ({VIT_BATCH},3,{VIT_PX},{VIT_PX}) '
                 'k16 s16 +bias', 1,
                 lambda: case((VIT_BATCH, 3, VIT_PX, VIT_PX), (16, 16), 0,
                              has_bias=True, k=(16, 16)))]
    if mobilenet:
        # MobileNetV1 at 176 px (phase 32): the 3x3/2 stem and the 1x1
        # pointwise convs (the 512-channel ones at 11 px are blocks 6-10).
        return [(f'mobilenet D={c * k[0] * k[1]} ({MB_BATCH},{c},{h},{w}) '
                 f'k{k[0]} s{s[0]}', count,
                 lambda c=c, h=h, w=w, k=k, s=s: case(
                     (MB_BATCH, c, h, w), s, (k[0] // 2, k[1] // 2), k=k))
                for (c, h, w), k, s, count in mobilenet['conv_a']]
    if resnet50:
        return [(f'D={c * k[0] * k[1]} ({R50_BATCH},{c},{h},{w}) k{k[0]} '
                 f's{s[0]}', count,
                 lambda c=c, h=h, w=w, k=k, s=s: case(
                     (R50_BATCH, c, h, w), s, (k[0] // 2, k[1] // 2), k=k))
                for (c, h, w), k, s, count in resnet50['conv_a']]
    s1, s2 = (1, 1), (2, 2)
    return [
        ('stem D=27 (128,3,32,32)', 1, lambda: case((128, 3, 32, 32), s1, 1)),
        ('D=144 (128,16,32,32)', 10, lambda: case((128, 16, 32, 32), s1, 1)),
        ('D=144 stride 2 (128,16,32,32)', 1,
         lambda: case((128, 16, 32, 32), s2, 1)),
        ('D=288 (128,32,16,16)', 9, lambda: case((128, 32, 16, 16), s1, 1)),
        ('D=288 stride 2 (128,32,16,16)', 1,
         lambda: case((128, 32, 16, 16), s2, 1)),
        ('D=576 (128,64,8,8)', 9, lambda: case((128, 64, 8, 8), s1, 1)),
        ('SAME stride 2 +bias (7,3,9,9)', 0,
         lambda: case((7, 3, 9, 9), s2, 'SAME', has_bias=True)),
        ('channels-last (5,4,6,6)', 0,
         lambda: case((5, 4, 6, 6), s1, 1, channels_last=True)),
        # One per staging path patch_cov_plan can choose, past one tile:
        # the implicit im2col (the ResNet-50 stem, 1 x 1 stride 2) and
        # K1's paths for 1 x 1 stride 1 (a 7 x 7 grid: 4-byte K-major;
        # channels-last: 4-byte along features; 14 x 14 with a bias:
        # 16-byte K-major).
        ('stem 7x7 s2 D=147 (8,3,224,224)', 0,
         lambda: case((8, 3, 224, 224), s2, 3, k=(7, 7))),
        ('1x1 s2 D=256 (8,256,56,56)', 0,
         lambda: case((8, 256, 56, 56), s2, 0, k=(1, 1))),
        ('1x1 on 7x7 D=512 (16,512,7,7)', 0,
         lambda: case((16, 512, 7, 7), s1, 0, k=(1, 1))),
        ('channels-last 1x1 D=160 (8,160,14,14)', 0,
         lambda: case((8, 160, 14, 14), s1, 0, channels_last=True,
                      k=(1, 1))),
        ('1x1 +bias D=200 (8,200,14,14)', 0,
         lambda: case((8, 200, 14, 14), s1, 0, has_bias=True, k=(1, 1))),
    ]


def bucket_precond_cases(gen, dev, resnet50=None, xl=False,
                         eigen_path=False, vit=False, mobilenet=None):
    """K3's cases. ``eigen_path`` (the ResNet-152 path under ``eigen``):
    every bucket eigen, timed, and checked again fed bf16 stacks (bf16
    inverse storage, which the wrapper widens)."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K

    def orth(s, n):
        q, _ = torch.linalg.qr(torch.randn((s, n, n), generator=gen,
                                           device=dev))
        return q.contiguous()

    def case(s, g_dim, a_dim, eigen=True, bf16_stacks=False):
        g = torch.randn((s, g_dim, a_dim), generator=gen, device=dev)
        if eigen:
            entry = {'QA': orth(s, a_dim), 'QG': orth(s, g_dim),
                     'dA': 0.1 + 1.9 * torch.rand((s, a_dim), generator=gen,
                                                  device=dev),
                     'dG': 0.1 + 1.9 * torch.rand((s, g_dim), generator=gen,
                                                  device=dev)}
        else:
            def spd(n):
                m = torch.randn((s, n, n), generator=gen, device=dev)
                return (m @ m.mT / n + 0.5 * torch.eye(n, device=dev)
                        ).contiguous()
            entry = {'A_inv': spd(a_dim), 'G_inv': spd(g_dim)}
        if bf16_stacks:
            entry = {k: t.bfloat16() for k, t in entry.items()}
        damping = 0.003

        def kern(bf16, both=True):
            return K.bucket_precond(g, entry, damping,
                                    compute_dtype=torch.bfloat16 if bf16
                                    else None)

        def plain(bf16, both=True):
            return K.bucket_precond_plain(g, entry, damping, bf16=bf16)

        def library():
            e = {k: t.float() for k, t in entry.items()}
            if eigen:
                qa, qg = e['QA'], e['QG']
                t = torch.bmm(torch.bmm(qg.mT, g), qa) / (
                    e['dG'][:, :, None] * e['dA'][:, None, :] + damping)
                v = torch.bmm(torch.bmm(qg, t), qa.mT)
            else:
                v = torch.bmm(torch.bmm(e['G_inv'], g), e['A_inv'])
            return v, (v * g).sum(dim=(1, 2))

        kern.inputs = (g, entry, damping)
        kern.plan = K.bucket_precond_plan(
            s, g_dim, a_dim, eigen, K._sm_count(g.device.index or 0),
            aligned=all(t.data_ptr() % 16 == 0
                        for t in (g, *entry.values())))
        slots = a_dim * a_dim + g_dim * g_dim + ((a_dim + g_dim) if eigen
                                                  else 0)
        nbytes = s * (4 * (2 * g_dim * a_dim + 1)
                      + (2 if bf16_stacks else 4) * slots)
        flops = s * (4 if eigen else 2) * g_dim * a_dim * (a_dim + g_dim)
        return kern, plain, library, nbytes, flops

    if mobilenet:
        # The MobileNetV1 step's buckets in the form 'auto' gives them:
        # eigen where both sides are at most 640, baked otherwise.
        return [(f'mobilenet {"eigen" if e else "baked"} ({s},{g_dim},'
                 f'{a_dim})', 1,
                 lambda s=s, g=g_dim, a=a_dim, e=e: case(s, g, a, e))
                for (g_dim, a_dim), s in mobilenet['buckets']
                for e in [max(g_dim, a_dim) <= 640]]
    if vit:
        # The ViT-S/16 step's five buckets in the form 'auto' gives them
        # (phase 33 checks the forms on its state).
        return [(f'vit {form} ({s},{g_dim},{a_dim})', 1,
                 lambda s=s, g=g_dim, a=a_dim, e=form == 'eigen': case(
                     s, g, a, e))
                for (g_dim, a_dim), s, form in VIT_K3_BUCKETS]
    if xl:
        # Under 'auto' every side above 640 is baked: the main path's
        # three buckets, timed once per step.
        return [(f'xl baked ({s},{g_dim},{a_dim})', 1,
                 lambda s=s, g=g_dim, a=a_dim: case(s, g, a, False))
                for (g_dim, a_dim), s in XL_K3_BUCKETS]
    if resnet50 and eigen_path:
        out = []
        for (g_dim, a_dim), s in resnet50['buckets']:
            out.append((f'eigen ({s},{g_dim},{a_dim})', 1,
                        lambda s=s, g=g_dim, a=a_dim: case(s, g, a)))
            out.append((f'eigen bf16 stacks ({s},{g_dim},{a_dim})', 0,
                        lambda s=s, g=g_dim, a=a_dim: case(
                            s, g, a, bf16_stacks=True)))
        return out
    if resnet50:
        # Under 'newton' every bucket is baked (timed, once per step);
        # the eigen form is checked at the same shapes.
        out = []
        for (g_dim, a_dim), s in resnet50['buckets']:
            out.append((f'baked ({s},{g_dim},{a_dim})', 1,
                        lambda s=s, g=g_dim, a=a_dim: case(s, g, a, False)))
            out.append((f'eigen ({s},{g_dim},{a_dim})', 0,
                        lambda s=s, g=g_dim, a=a_dim: case(s, g, a)))
        return out
    return [
        ('(1,16,27)', 1, lambda: case(1, 16, 27)),
        ('(10,16,144)', 1, lambda: case(10, 16, 144)),
        ('(1,32,144)', 1, lambda: case(1, 32, 144)),
        ('(9,32,288)', 1, lambda: case(9, 32, 288)),
        ('(1,64,288)', 1, lambda: case(1, 64, 288)),
        ('(9,64,576)', 1, lambda: case(9, 64, 576)),
        ('(1,10,65)', 1, lambda: case(1, 10, 65)),
        ('baked (3,10,65)', 0, lambda: case(3, 10, 65, eigen=False)),
        ('ragged (2,70,130)', 0, lambda: case(2, 70, 130)),
    ]


def lstm_bucket_precond_cases(gen, dev):
    """The LSTM LM path's one K3 bucket: 16 gates, G 650 x A 651 (eigen
    under ``jacobi``, baked under the defaults' Cholesky)."""
    cases = {label: make for label, _, make in bucket_precond_cases(
        gen, dev, {'buckets': [((650, 651), 16)]})}
    return [('eigen (16,650,651)', 1, cases['eigen (16,650,651)']),
            ('baked (16,650,651)', 0, cases['baked (16,650,651)'])]


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max over outputs of max abs error / max |ref|)."""
    import torch
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    abs_err, rel = 0.0, 0.0
    for g, r in zip(got, ref, strict=True):
        g, r = g.float(), r.float()
        if g.shape != r.shape:
            raise AssertionError(f'shape {tuple(g.shape)} != '
                                 f'{tuple(r.shape)}')
        if not torch.isfinite(g).all():
            raise AssertionError('non-finite kernel output')
        err = float((g - r).abs().max())
        abs_err = max(abs_err, err)
        rel = max(rel, err / max(float(r.abs().max()), 1e-30))
    return abs_err, rel


def resnet50_shapes() -> dict:
    """:func:`resnet_shapes` of ResNet-50."""
    return resnet_shapes('resnet50')


def resnet_shapes(model_name: str) -> dict:
    """The shapes an ImageNet ResNet's path (224 px) gives K1-K3
    (:func:`layer_shapes`)."""
    from distributed_kfac_pytorch_tpu_torch.models import imagenet_resnet
    return layer_shapes(imagenet_resnet.get_model(model_name), 224)


def mobilenet_shapes() -> dict:
    """The shapes MobileNetV1's path (phase 32, ``MB_PX``) gives K1-K3
    (:func:`layer_shapes`; the depthwise convs launch no kernel)."""
    from distributed_kfac_pytorch_tpu_torch.models import mobilenet
    return layer_shapes(mobilenet.get_model(1000), MB_PX)


def layer_shapes(model, px: int) -> dict:
    """The shapes a conv net's K-FAC step at ``px`` gives K1-K3, from one
    forward pass of ``model`` on the CPU at batch 1: conv output (C, H, W)
    with counts, conv input (C, H, W) + kernel + stride with counts, the
    head's (in, out) and the precondition buckets ((G, A), layers);
    grouped convs are left out."""
    import collections
    import torch
    model = model.eval()
    seen = []
    for mod in model.modules():
        if isinstance(mod, torch.nn.Linear) or (
                isinstance(mod, torch.nn.Conv2d) and mod.groups == 1):
            mod.register_forward_hook(
                lambda m, i, o: seen.append((m, tuple(i[0].shape[1:]),
                                             tuple(o.shape[1:]))))
    with torch.no_grad():
        model(torch.zeros(1, 3, px, px))
    conv_g, conv_a, buckets = (collections.Counter() for _ in range(3))
    fc = None
    for m, x_shape, y_shape in seen:
        w = m.weight
        if isinstance(m, torch.nn.Conv2d):
            conv_g[y_shape] += 1
            conv_a[(x_shape, tuple(m.kernel_size), tuple(m.stride))] += 1
            buckets[(w.shape[0], w[0].numel())] += 1
        else:
            fc = (w.shape[1], w.shape[0])
            buckets[(w.shape[0], w.shape[1] + 1)] += 1
    return {'conv_g': sorted(conv_g.items()),
            'conv_a': [(*k, n) for k, n in sorted(conv_a.items())],
            'fc': fc, 'buckets': sorted(buckets.items())}


def plan_fields(plan) -> dict:
    """What a phase-3 row records of a kernel's plan: K1's and K2's tile,
    tile pairs, split-K chunks and staging path; K3's tile, staging path
    and waves."""
    if hasattr(plan, 'npairs'):
        return {'tile': plan.tile, 'pairs': plan.npairs,
                'chunks': plan.chunks, 'staging': plan.path}
    return {'tile': f'{plan.tile_m}x128', 'staging': plan.path,
            'waves': plan.waves}


def check_kernels(quick: bool, resnet50: dict | None = None,
                  lstm: bool = False, xl: bool = False,
                  config5: bool = False, vit: bool = False,
                  mobilenet: bool = False) -> tuple[dict, list]:
    """K1-K3 against their plain versions at the ResNet-32 shapes (or,
    given ``resnet50_shapes()``, the ResNet-50 ones; with ``lstm``, K3 at the
    LSTM LM's bucket; with ``xl``, K1 and K3 at the Transformer-XL step's
    shapes; with ``vit``, K1-K3 at the ViT-S/16 step's shapes; with
    ``mobilenet``, K1-K3 at the MobileNetV1 step's; with ``config5`` and
    ``resnet_shapes('resnet152')``, tracked config 5's modes: K1 with bf16
    storage, K3 on eigen buckets, also fed bf16 stacks, and K1 and K2 timed
    with bf16 multiplicands); per-step sums of the timed cases' ms, plain ms,
    library ms and bounds. A K1 case in bf16-storage mode is also held bit for
    bit
    against the widen, fp32 launch, round sequence and timed beside it."""
    import torch
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # The multiplicand mode each kernel is timed in: config 5's path runs
    # K1 and K2 with bf16 multiplicands (--bf16-factors).
    timed_bf16 = {'factor_ema': config5, 'patch_cov': config5}
    if lstm:
        families = {'bucket_precond': lstm_bucket_precond_cases(gen, dev)}
    elif vit:
        families = {'factor_ema': factor_ema_cases(gen, dev, vit=True),
                    'patch_cov': patch_cov_cases(gen, dev, vit=True),
                    'bucket_precond': bucket_precond_cases(gen, dev,
                                                           vit=True)}
    elif mobilenet:
        shapes = mobilenet_shapes()
        families = {
            'factor_ema': factor_ema_cases(gen, dev, mobilenet=shapes),
            'patch_cov': patch_cov_cases(gen, dev, mobilenet=shapes),
            'bucket_precond': bucket_precond_cases(gen, dev,
                                                   mobilenet=shapes)}
    elif xl:
        families = {'factor_ema': factor_ema_cases(gen, dev, xl=True),
                    'bucket_precond': bucket_precond_cases(gen, dev,
                                                           xl=True)}
    else:
        families = {
            'factor_ema': factor_ema_cases(gen, dev, resnet50,
                                           storage_bf16=config5),
            'patch_cov': patch_cov_cases(gen, dev, resnet50),
            'bucket_precond': bucket_precond_cases(gen, dev, resnet50,
                                                   eigen_path=config5)}
    model = ('lstm' if lstm else 'transformer_xl' if xl
             else 'vit_small' if vit else 'mobilenet_v1' if mobilenet
             else 'resnet152' if config5
             else 'resnet50' if resnet50 else 'resnet32')
    summary, details = {}, []
    for name, cases in families.items():
        peak = OPS_PEAK.get(name, PEAK_FP32_FLOPS)
        agg = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
               't_bytes': 0.0, 't_ops': 0.0, 'fp32_bound_ms': 0.0,
               'max_abs_err': 0.0}
        timed = timed_bf16.get(name, False)
        if timed:
            # bf16 multiplicands: the same products could run on the bf16
            # tensor cores.
            peak = PEAK_BF16_FLOPS
        for label, count, make in cases:
            kern, plain, library, nbytes, flops = make()
            widened = getattr(kern, 'widened', None)
            row = {'kernel': name, 'case': label, 'per_step': count,
                   'model': model, 'timed_mode': 'bf16' if timed else 'fp32'}
            plan = getattr(kern, 'plan', None)
            desc = plan_fields(plan) if plan is not None else {}
            row.update(desc)
            for mode, bf16, tol in (('fp32', False, TOL_FP32[name]),
                                    ('bf16', True, TOL_BF16)):
                got = kern(bf16)
                torch.cuda.synchronize()
                ref = plain(bf16)
                if widened is None:
                    abs_err, rel = rel_err(got, ref)
                else:
                    # The bf16-stored blend: the kernel's and the plain
                    # version's fp32 blends may part at a rounding
                    # boundary, so it is held to one bf16 ulp of its
                    # largest entry; the contraction at the mode's
                    # tolerance.
                    abs_err, rel = rel_err(got[1:], ref[1:])
                    _, rel_store = rel_err(got[:1], ref[:1])
                    row[f'{mode}_storage_rel_err'] = rel_store
                    if not rel_store <= BF16_ULP:
                        raise AssertionError(
                            f'{name} {label} {mode}: bf16-stored blend rel '
                            f'err {rel_store:.3g} > {BF16_ULP}')
                row[f'{mode}_abs_err'] = abs_err
                row[f'{mode}_rel_err'] = rel
                if not rel <= tol:
                    raise AssertionError(
                        f'{name} {label} {mode}: rel err {rel:.3g} > {tol}')
                blend = getattr(kern, 'blend', None)
                if blend is not None and not bf16:
                    differ = int((blend(got[1]) != got[0]).sum())
                    if differ:
                        raise AssertionError(
                            f'{name} {label}: kernels.ema_blend of the '
                            f'contraction differs from the fused blend in '
                            f'{differ} entries')
                if widened is not None:
                    differ = int((widened(bf16) != got[0]).sum())
                    if got[0].dtype != torch.bfloat16 or differ:
                        raise AssertionError(
                            f'{name} {label} {mode}: bf16 storage differs '
                            f'from widen, launch, round in {differ} '
                            f'entries ({got[0].dtype})')
                if plan is not None:
                    # K1 and K2 mirror every upper entry from its lower
                    # one; K1-K3 sum their partials in a fixed order.
                    again = kern(bf16)
                    for g, h in zip(got, again, strict=True):
                        if name in ('factor_ema', 'patch_cov') and \
                                not torch.equal(g, g.T):
                            raise AssertionError(
                                f'{name} {label} {mode}: not symmetric')
                        if not torch.equal(g, h):
                            raise AssertionError(
                                f'{name} {label} {mode}: two calls differ')
            msg = (f'  {name:15s} {label:34s} fp32 rel '
                   f'{row["fp32_rel_err"]:.2e}  bf16 rel '
                   f'{row["bf16_rel_err"]:.2e}')
            msg += ''.join(f'  {k} {v}' for k, v in desc.items())
            if not quick and (count or widened is not None):
                reps = 20 if flops < 2e10 else 5
                row['ms'] = time_ms(lambda: kern(timed, both=False), reps)
                row['plain_ms'] = time_ms(lambda: plain(timed, both=False),
                                          reps)
                row['library_ms'] = time_ms(library, reps)
                row['bound_ms'], row['bound_by'] = bound(nbytes, flops,
                                                         peak)
                row['fp32_bound_ms'] = bound(nbytes, flops)[0]
                msg += (f'  ms {row["ms"]:.4f} plain {row["plain_ms"]:.4f}'
                        f' lib {row["library_ms"]:.4f} bound '
                        f'{row["bound_ms"]:.4f} ({row["bound_by"]}, '
                        f'{100 * row["bound_ms"] / row["ms"]:.1f} %)')
                if peak != PEAK_FP32_FLOPS:
                    msg += f' fp32 bound {row["fp32_bound_ms"]:.4f}'
                if widened is not None:
                    row['widened_ms'] = time_ms(lambda: widened(timed),
                                                reps)
                    msg += f' widen+fp32+round {row["widened_ms"]:.4f}'
            if not quick and count:
                agg['ms'] += count * row['ms']
                agg['plain_ms'] += count * row['plain_ms']
                agg['library_ms'] += count * row['library_ms']
                agg['t_bytes'] += count * nbytes / PEAK_BYTES * 1e3
                agg['t_ops'] += count * flops / peak * 1e3
                agg['fp32_bound_ms'] += count * row['fp32_bound_ms']
                agg['max_abs_err'] = max(agg['max_abs_err'],
                                         row['fp32_abs_err'])
            log(msg)
            details.append(row)
            del kern, plain, library
        summary[name] = agg
    return summary, details


# ---------------------------------------------------------------------------
# K4: the Newton--Schulz inverse
# ---------------------------------------------------------------------------

def ns_bounds(n: int, count: int, iters) -> tuple[tuple, tuple]:
    """Bounds of one K4 call, the stack read once and the inverses written
    once, 4 n^3 fp32 FLOPs per matrix and iteration run: (on the tensor
    cores at 3 TF32 products per fp32 product, the kernel's own; on the
    fp32 CUDA cores), each (ms, 'bytes' or 'operations')."""
    nbytes, flops = 8.0 * count * n * n, 4.0 * n ** 3 * float(sum(iters))
    return (bound(nbytes, 3 * flops, PEAK_TF32_FLOPS),
            bound(nbytes, flops))


def _ns_residual(f, damping, x) -> float:
    """``max|(F + damping I) X - I|``, computed in float64 so that the
    product's own rounding does not swamp the accuracy of ``X``."""
    import torch
    f, x = f.double(), x.double()
    eye = torch.eye(f.shape[-1], dtype=torch.float64, device=f.device)
    return float(((f + damping * eye) @ x - eye).abs().max())


def _spd_stack(gen, count: int, n: int, ks=None, shift: float = 0.0):
    """``count`` SPD matrices ``shift I + W W^T / k`` with W (n, k)
    Gaussian (default k = 2n: eigenvalues of ``W W^T / k`` in
    ~[0.09, 2.9])."""
    import torch
    mats = []
    for i in range(count):
        k = ks[i] if ks else 2 * n
        w = torch.randn((n, k), generator=gen, device='cuda')
        mats.append((w @ w.T) / k
                    + shift * torch.eye(n, device='cuda'))
    return torch.stack(mats).contiguous()


def check_ns_inverse(quick: bool) -> tuple[dict, list]:
    """K4 against its plain version at every ResNet-50 size bucket and the
    edge sizes, damping 0.003 and 0.001, plus stacks whose matrices stop
    at different iterations (all converging, and a cap of 8 iterations
    that the slower ones reach). Returns the per-firing sums (ResNet-50
    buckets at damping 0.001, the main path's) and the per-case rows."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1)
    cases = []
    # Above n = 1024 the fp32 fixed point of the iteration sits at the
    # tolerance for condition ~34 (both versions measured ~2.6e-5 at
    # n = 2048 on the H100), so whether a matrix stops early there is down
    # to rounding: those buckets get the identity-seeded form of a K-FAC
    # factor, I + W W^T / 2n (condition ~3.6), and stop well clear of it.
    for damping in (0.003, 0.001):
        for n, count in R50_NS_BUCKETS:
            cases.append((f'R50 ({count},{n},{n}) l={damping}', damping,
                          100, count if damping == 0.001 else 0,
                          lambda n=n, c=count: _spd_stack(
                              gen, c, n, shift=1.0 if n > 1024 else 0.0)))
        for n in NS_EDGE_SIZES:
            cases.append((f'edge (2,{n},{n}) l={damping}', damping, 100, 0,
                          lambda n=n: _spd_stack(gen, 2, n)))
    # Condition numbers ~4, 9, 34 and 97: the matrices stop at different
    # iterations, and under a cap of 8 the slower ones stop at the cap.
    varied = lambda: _spd_stack(gen, 4, 100,  # noqa: E731
                                ks=[1000, 400, 200, 150])
    cases.append(('varied stop (4,100,100) l=0.001', 0.001, 100, 0, varied))
    cases.append(('cap 8 (4,100,100) l=0.001', 0.001, 8, 0, varied))
    agg = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0, 'bound_ms': 0.0,
           'fp32_bound_ms': 0.0, 't_bytes': 0.0, 't_ops': 0.0,
           'max_abs_err': 0.0}
    rows = []
    for label, damping, iters, timed, make in cases:
        f = make()
        n = f.shape[-1]
        got, k_got = K.batched_inverse(f, damping, iters, with_iters=True)
        torch.cuda.synchronize()
        ref, k_ref = K.batched_inverse_plain(f, damping, iters)
        k_got, k_ref = k_got.tolist(), k_ref.tolist()
        if not torch.isfinite(got).all():
            raise AssertionError(f'ns_inverse {label}: non-finite output')
        abs_err = float((got - ref).abs().max())
        rel_fro = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
        res_got = _ns_residual(f, damping, got)
        res_ref = _ns_residual(f, damping, ref)
        row = {'kernel': 'ns_inverse', 'case': label, 'n': n,
               'count': f.shape[0], 'damping': damping, 'iters_cap': iters,
               'iters': k_got, 'plain_iters': k_ref, 'max_abs_err': abs_err,
               'rel_fro_err': rel_fro, 'residual': res_got,
               'plain_residual': res_ref, 'per_firing': timed}
        if n <= 1024:
            ok = rel_fro <= NS_TOL
        else:
            ok = (res_got <= 2 * res_ref and all(
                abs(a - b) <= 1 for a, b in zip(k_got, k_ref)))
        if not ok:
            raise AssertionError(f'ns_inverse {label}: rel Frobenius '
                                 f'{rel_fro:.3g}, residual {res_got:.3g} vs '
                                 f'plain {res_ref:.3g}, iterations {k_got} '
                                 f'vs {k_ref}')
        msg = (f'  ns_inverse {label:34s} iters {k_got} (plain {k_ref}) '
               f'rel fro {rel_fro:.2e} residual {res_got:.2e} (plain '
               f'{res_ref:.2e})')
        if not quick and timed:
            reps, trials, warm = (1, 3, 1) if n >= 1024 else (5, 5, 3)
            row['ms'] = time_ms(lambda: K.batched_inverse(f, damping, iters),
                                reps, trials, warm)
            row['plain_ms'] = time_ms(
                lambda: K.batched_inverse_plain(f, damping, iters), reps,
                trials, warm)
            eye = torch.eye(n, device='cuda')
            row['library_ms'] = time_ms(lambda: torch.cholesky_inverse(
                torch.linalg.cholesky(f + damping * eye)), reps, trials, warm)
            ((row['bound_ms'], row['bound_by']),
             (row['fp32_bound_ms'], row['fp32_bound_by'])) = ns_bounds(
                 n, f.shape[0], k_got)
            for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms',
                        'fp32_bound_ms'):
                agg[key] += row[key]
            agg['t_bytes'] += 8.0 * f.shape[0] * n * n / PEAK_BYTES * 1e3
            agg['t_ops'] += (3 * 4.0 * n ** 3 * sum(k_got)
                             / PEAK_TF32_FLOPS * 1e3)
            agg['max_abs_err'] = max(agg['max_abs_err'], abs_err)
            msg += (f'  ms {row["ms"]:.3f} plain {row["plain_ms"]:.3f} lib '
                    f'(cholesky_inverse) {row["library_ms"]:.3f} bound '
                    f'(3xTF32, read against) {row["bound_ms"]:.3f} '
                    f'({row["bound_by"]}) fp32 bound '
                    f'{row["fp32_bound_ms"]:.3f}')
        log(msg)
        rows.append(row)
        del f, got, ref
    if agg['ms']:
        log(f'  K4 per ResNet-50 firing: {agg["ms"]:.2f} ms; bound '
            f'(3xTF32, read against) {agg["bound_ms"]:.2f} ms '
            f'({agg["bound_ms"] / agg["ms"]:.1%} of it reached), fp32 '
            f'bound {agg["fp32_bound_ms"]:.2f} ms '
            f'({agg["fp32_bound_ms"] / agg["ms"]:.1%}); library '
            f'{agg["library_ms"]:.2f} ms')
    return agg, rows


def run_main_path() -> tuple[dict, dict]:
    from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    config = {'model': 'resnet32', 'batch_size': 128,
              'synthetic_size': 128, 'val_batch_size': 32,
              'epochs': STEPS, 'no_augment': True, 'seed': 0,
              'kfac_update_freq': 10, 'kfac_cov_update_freq': 1,
              'damping': 0.003, 'kl_clip': 0.001, 'base_lr': 0.1,
              'momentum': 0.9, 'wd': 5e-4, 'time_steps': True,
              'quiet': True}
    kernels.reset_launches()
    res = train_cifar10_resnet.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    res.pop('state')
    losses = res['losses']
    n = res['steps']
    log(f'  losses: {[round(v, 4) for v in losses]}')
    if n != STEPS or len(losses) != STEPS:
        raise AssertionError(f'expected {STEPS} steps, ran {n}')
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('non-finite loss on the main path')
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f'loss did not decrease: first five '
                             f'{first:.4f}, last five {last:.4f}')
    for name, per_step in {**EXPECTED_PER_STEP, 'jacobi_eigh': 0}.items():
        if launches[name] != per_step * n:
            raise AssertionError(f'{name}: {launches[name]} launches, '
                                 f'expected {per_step} x {n}')
    ms, fired = res['step_ms'], res['fired']
    firing = [t for i, (t, f) in enumerate(zip(ms, fired))
              if f == 'inverse' and i > 0]
    plain = [t for i, (t, f) in enumerate(zip(ms, fired))
             if f == 'factor' and i > 1]
    summary = {'steps': n, 'loss_first5': first, 'loss_last5': last,
               'firing_ms_median': statistics.median(firing),
               'nonfiring_ms_median': statistics.median(plain),
               'launches': launches, 'val': res['val']}
    log(f'  loss first five {first:.4f} -> last five {last:.4f}; '
        f'launches {launches}')
    return summary, res


def _r50_config(**over) -> dict:
    config = {'model': 'resnet50', 'image_size': 224,
              'batch_size': R50_BATCH, 'synthetic_size': R50_BATCH,
              'val_batch_size': R50_BATCH, 'no_augment': True, 'seed': 0,
              'kfac_update_freq': R50_FIRE_EVERY, 'kfac_cov_update_freq': 1,
              'damping': 0.001, 'kl_clip': 0.001, 'label_smoothing': 0.1,
              'base_lr': R50_LR, 'time_steps': True, 'quiet': True}
    config.update(over)
    return config


def _step_ms(res) -> tuple[list, list]:
    """(firing, non-firing) step ms, leaving out step 0 (first calls)."""
    ms, fired = res['step_ms'], res['fired']
    firing = [t for i, (t, f) in enumerate(zip(ms, fired))
              if f == 'inverse' and i > 0]
    plain = [t for i, (t, f) in enumerate(zip(ms, fired))
             if f != 'inverse' and i > 0]
    return firing, plain


def run_resnet50_newton(card: str) -> tuple[dict, dict]:
    """Phase 6: 12 ResNet-50 steps under 'newton', then the final factors'
    size buckets through K4 one by one (iterations, residual, ms)."""
    import torch
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    config = _r50_config(epochs=R50_STEPS, inverse_method='newton')
    kernels.reset_launches()
    res = train_imagenet_resnet.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    state = res.pop('state')
    losses, n = res['losses'], res['steps']
    log(f'  lr {R50_LR}; losses: {[round(v, 4) for v in losses]}')
    if n != R50_STEPS or len(losses) != R50_STEPS:
        raise AssertionError(f'expected {R50_STEPS} steps, ran {n}')
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('non-finite loss on the ResNet-50 path')
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'loss did not decrease: first three '
                             f'{first:.4f}, last three {last:.4f}')
    firings = res['fired'].count('inverse')
    expected = {name: per * n for name, per in R50_PER_STEP.items()}
    expected['ns_inverse'] = R50_PER_FIRING * firings
    expected['jacobi_eigh'] = 0
    if launches != expected:
        raise AssertionError(f'launches {launches}, expected {expected}')
    firing, plain = _step_ms(res)
    summary = {'steps': n, 'lr': R50_LR, 'losses': losses,
               'loss_first3': first, 'loss_last3': last,
               'firings': firings, 'launches': launches,
               'firing_ms': firing, 'step0_ms': res['step_ms'][0],
               'nonfiring_ms_median': statistics.median(plain),
               'nonfiring_ms': plain}
    log(f'  loss first three {first:.4f} -> last three {last:.4f}; '
        f'launches {launches}')
    log(f'  ms/step: non-firing {summary["nonfiring_ms_median"]:.2f} '
        f'(median), firing {firing} (step 0: {res["step_ms"][0]:.1f}) '
        f'({card})')
    # The final factors, bucketed by size as a firing does, through K4.
    by_size: dict[int, list] = {}
    for f in state.kfac_state['factors'].values():
        for t in f.values():
            by_size.setdefault(t.shape[-1], []).append(t)
    buckets = []
    total_ms = 0.0
    for mats in by_size.values():
        stack = torch.stack(mats)
        inv, k = kernels.batched_inverse(stack, config['damping'],
                                         state.kfac.newton_iters,
                                         with_iters=True)
        ms = time_ms(lambda: kernels.batched_inverse(
            stack, config['damping'], state.kfac.newton_iters), 1, 3, 1)
        # The plain version once, untimed: whether a stall at the cap is
        # the fp32 iteration's or the kernel's.
        inv_p, k_p = kernels.batched_inverse_plain(
            stack, config['damping'], state.kfac.newton_iters)
        row = {'n': stack.shape[-1], 'count': len(mats),
               'iters': k.tolist(), 'plain_iters': k_p.tolist(),
               'residual': _ns_residual(stack, config['damping'], inv),
               'plain_residual': _ns_residual(stack, config['damping'],
                                              inv_p),
               'ms': ms}
        total_ms += ms
        buckets.append(row)
        log(f'    bucket ({row["count"]},{row["n"]},{row["n"]}): iterations '
            f'{row["iters"]} (plain {row["plain_iters"]}), max|MX-I| '
            f'{row["residual"]:.2e} (plain {row["plain_residual"]:.2e}), '
            f'{ms:.2f} ms')
    log(f'  K4 over the final factors: {total_ms:.1f} ms per firing')
    summary['final_factor_buckets'] = buckets
    summary['final_factor_k4_ms'] = total_ms
    return summary, res


def run_resnet50_auto(card: str) -> dict:
    """Phase 7: 3 ResNet-50 steps under the default 'auto' (one firing)."""
    import torch
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    config = _r50_config(epochs=3)
    _release()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = train_imagenet_resnet.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    state = res.pop('state')
    losses = res['losses']
    if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'auto: losses {losses}')
    if res['fired'].count('inverse') != 1:
        raise AssertionError(f'auto: fired {res["fired"]}')
    expected = {name: per * 3 for name, per in R50_PER_STEP.items()}
    expected['ns_inverse'] = expected['jacobi_eigh'] = 0
    if launches != expected:
        raise AssertionError(f'auto: launches {launches}, expected '
                             f'{expected}')
    # The 21 shape buckets, split by the form the kernel ran.
    groups: dict[tuple, str] = {}
    for name, entry in state.kfac_state['inverses'].items():
        w = dict(state.model.named_parameters())[f'{name}.weight']
        shape = (w.shape[0], w[0].numel() + int(
            state.kfac.specs[name].has_bias))
        groups[shape] = 'baked' if 'A_inv' in entry else 'eigen'
    split = {form: list(groups.values()).count(form)
             for form in ('eigen', 'baked')}
    if len(groups) != R50_PER_STEP['bucket_precond'] or min(
            split.values()) == 0:
        raise AssertionError(f'auto: bucket forms {split}')
    summary = {'losses': losses, 'launches': launches,
               'bucket_forms': split, 'firing_ms': res['step_ms'][0],
               'nonfiring_ms': res['step_ms'][1:], 'peak_gib': peak}
    log(f'  losses {[round(v, 4) for v in losses]}; launches {launches}; '
        f'buckets {split}')
    log(f'  firing step (step 0) {res["step_ms"][0]:.1f} ms, non-firing '
        f'{[round(t, 2) for t in res["step_ms"][1:]]} ms; peak {peak:.2f} '
        f'GiB above the baseline ({card})')
    return summary


def _r152_run(label: str, card: str, steps: int, buckets: int,
              inspect=None, **flags) -> dict:
    """One config-5-shaped run of ``train_imagenet_resnet.train``
    (ResNet-152, 224 px, batch 64, ``eigen``, inverses every 10, lr
    ``R152_LR``) with the
    launch counts reset just before and read just after: every loss
    finite, launches K1 157, K2 155 and K3 ``buckets`` per step and no K4
    or K5. Returns its losses, step ms, peak allocated memory, the bytes
    and dtypes of the factor and inverse state, and what ``inspect(train
    state)`` returns (run on the final state before it is freed)."""
    import torch
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    config = _r50_config(model='resnet152', epochs=steps,
                         inverse_method='eigen', base_lr=R152_LR, **flags)
    _release()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = train_imagenet_resnet.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    state = res.pop('state')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, n = res['losses'], res['steps']
    log(f'  {label}: losses {[round(v, 4) for v in losses]}')
    if n != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'{label}: {n} steps, losses {losses}')
    expected = {name: per * n for name, per in R152_PER_STEP.items()}
    expected.update(bucket_precond=buckets * n, ns_inverse=0,
                    jacobi_eigh=0)
    if launches != expected:
        raise AssertionError(f'{label}: launches {launches}, expected '
                             f'{expected}')
    kst = state.kfac_state
    nbytes = {k: sum(t.numel() * t.element_size() for e in kst[k].values()
                     for t in e.values()) for k in ('factors', 'inverses')}
    dtypes = {k: sorted({str(t.dtype).replace('torch.', '')
                         for e in kst[k].values() for t in e.values()})
              for k in ('factors', 'inverses')}
    firing, plain = _step_ms(res)
    summary = {'steps': n, 'flags': flags, 'losses': losses,
               'launches': launches, 'fired': res['fired'],
               'step_ms': res['step_ms'], 'firing_ms': firing,
               'nonfiring_ms_median': statistics.median(plain),
               'peak_gib': peak, 'factor_bytes': nbytes['factors'],
               'inverse_bytes': nbytes['inverses'], 'dtypes': dtypes}
    if inspect is not None:
        summary.update(inspect(state))
    log(f'  {label}: ms/step non-firing {summary["nonfiring_ms_median"]:.2f}'
        f' (median of {len(plain)}), firing '
        f'{[round(t, 1) for t in firing]} (step 0, the first firing: '
        f'{res["step_ms"][0]:.1f}); peak allocated {peak:.2f} GiB; factors '
        f'{nbytes["factors"] / 1e9:.3f} GB {dtypes["factors"]}, inverses '
        f'{nbytes["inverses"] / 1e9:.3f} GB {dtypes["inverses"]} ({card})')
    del state
    _release()
    return summary


def run_resnet152_config5(card: str, r152: dict, xl: dict) -> dict:
    """Phase 23: tracked config 5, ``--model resnet152 --bf16-factors
    --inverse-method eigen``, 12 steps (firings at steps 0 and 10): every
    loss finite, the last three below the first three, every factor bf16
    and every inverse fp32 after the run, K1 157 / K2 155 / K3 one per
    bucket per step and no K4 or K5. Beside it, in the same call: 3 steps
    with fp32 factors, 3 steps with ``--bf16-factors --bf16-inverses
    --bf16-precond`` (inverses bf16), and the LM CLI at phase 15's XL
    width with the three flags (3 steps, one firing: the embedding's
    ``diag_inv`` bf16, step ms beside phase 15's ``xl``)."""
    import torch
    buckets = len(r152['buckets'])
    log(f'  ResNet-152: {buckets} shape buckets, K1 '
        f'{R152_PER_STEP["factor_ema"]} and K2 '
        f'{R152_PER_STEP["patch_cov"]} launches per step')
    main = _r152_run('bf16 factors', card, R152_STEPS, buckets,
                     bf16_factors=True)
    losses = main['losses']
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'config 5: loss did not decrease: first three '
                             f'{first:.4f}, last three {last:.4f}')
    if main['dtypes'] != {'factors': ['bfloat16'],
                          'inverses': ['float32']}:
        raise AssertionError(f'config 5: state dtypes {main["dtypes"]}')
    if main['fired'].count('inverse') != 2:
        raise AssertionError(f'config 5: fired {main["fired"]}')
    fp32 = _r152_run('fp32 factors', card, R152_SHORT_STEPS, buckets)
    flags = _r152_run('bf16 factors, inverses, precond', card,
                      R152_SHORT_STEPS, buckets, **BF16_FLAGS)
    if flags['dtypes'] != {'factors': ['bfloat16'],
                           'inverses': ['bfloat16']}:
        raise AssertionError(f'config 5, three flags: state dtypes '
                             f'{flags["dtypes"]}')
    log(f'  config 5 against fp32 factors: factor state '
        f'{main["factor_bytes"] / 1e9:.3f} / {fp32["factor_bytes"] / 1e9:.3f}'
        f' GB, non-firing {main["nonfiring_ms_median"]:.2f} / '
        f'{fp32["nonfiring_ms_median"]:.2f} ms, peak '
        f'{main["peak_gib"]:.2f} / {fp32["peak_gib"]:.2f} GiB')
    res, launches, state = _run_tlm(
        'transformer-xl, three bf16 flags',
        _xl_config(max_steps=R152_SHORT_STEPS, **BF16_FLAGS), XL_PER_STEP, 1)
    diag = state.kfac_state['inverses']['embed']['A_inv'].dtype
    dtypes = sorted({str(t.dtype) for e in state.kfac_state[
        'inverses'].values() for t in e.values()})
    if diag != torch.bfloat16 or dtypes != ['torch.bfloat16']:
        raise AssertionError(f'xl, three flags: diag_inv {diag}, '
                             f'inverses {dtypes}')
    del state
    _release()
    xl_ms = res['step_ms'][1:]
    lm = {'losses': res['losses'], 'launches': launches,
          'step_ms': res['step_ms'], 'peak_gib': res['peak_gib'],
          'nonfiring_ms_median': statistics.median(xl_ms),
          'phase15_nonfiring_ms_median': xl['nonfiring_ms_median']}
    log(f'  xl, three bf16 flags: ms/step non-firing '
        f'{lm["nonfiring_ms_median"]:.2f} (median of {len(xl_ms)}; phase 15 '
        f'{xl["nonfiring_ms_median"]:.2f}), firing (step 0) '
        f'{res["step_ms"][0]:.1f}; peak {res["peak_gib"]:.1f} GiB ({card})')
    return {'buckets': buckets, 'bf16_factors': main, 'fp32_factors': fp32,
            'three_flags': flags, 'transformer_xl_three_flags': lm,
            'launches': {k: main['launches'][k] + fp32['launches'][k]
                         + flags['launches'][k] + launches[k]
                         for k in launches}}


# ---------------------------------------------------------------------------
# Phase 25: the firing schedule at config 5
# ---------------------------------------------------------------------------

# Config 5 with its firing spread over 5 chunks (stride 2 at inverses every
# 10): 22 steps hold step 0's monolithic firing, chunks 1-4 at steps 2-8, a
# whole window 10-19 and chunk 0 again at 20.
SCHEDULE_STEPS, SCHEDULE_CHUNKS, SCHEDULE_FREQ = 22, 5, 10
R50_CHUNK_STEPS = 11
FRACTION = 0.25
XL_SCHEDULE = {'inv_pipeline_chunks': 2, 'deferred_factor_reduction': True}


def _schedule_fired(steps: int, **kw) -> list:
    """The fired stages ``cadence_flags`` gives steps ``0..steps-1`` at
    factors every step and inverses every SCHEDULE_FREQ."""
    from distributed_kfac_pytorch_tpu_torch.training import engine
    return [engine.fired_stage(engine.cadence_flags(s, 1, SCHEDULE_FREQ,
                                                    **kw))
            for s in range(steps)]


def _chunk_plan_summary(kfac, factors) -> list:
    """Per chunk of ``kfac``'s plan: its items, their ``dim^3`` share and
    the count of matrices of each size."""
    plan = kfac.inverse_chunk_plan(factors)
    cost = dict(kfac.inverse_chunk_items(factors))
    total = sum(cost.values())
    out = []
    for j in range(kfac.inv_pipeline_chunks):
        keys = [k for k, c in plan.items() if c == j]
        dims: dict[int, int] = {}
        for key in keys:
            if key[0] == 'mat':
                d = int(factors[key[1]][key[2]].shape[-1])
                dims[d] = dims.get(d, 0) + 1
        out.append({'chunk': j, 'items': len(keys),
                    'share': sum(cost[k] for k in keys) / total,
                    'matrices_by_dim': dict(sorted(dims.items()))})
    return out


def _frozen_window(kfac, state, launch_key: str | None = None) -> dict:
    """From ``state``, its factors frozen: one monolithic firing against a
    window of chunk firings, every inverse slot bit for bit. With
    ``launch_key`` (K4 or K5) each chunk firing must launch it once per
    size bucket with a matrix in the chunk, from the plan, and the
    monolithic firing their sum."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    factors = state['factors']
    plan = kfac.inverse_chunk_plan(factors)
    want = [len({int(factors[k[1]][k[2]].shape[-1])
                 for k, c in plan.items() if c == j and k[0] == 'mat'})
            for j in range(kfac.inv_pipeline_chunks)]

    def timed(fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, dict(kernels.LAUNCHES)

    mono, mono_ms, mono_launches = timed(lambda: kfac.update_inverses(state))
    cur, chunk_ms, chunk_launches = state, [], []
    for j in range(kfac.inv_pipeline_chunks):
        inv, ms, launches = timed(
            lambda j=j: kfac.update_inverses(cur, chunk=j))
        cur = {**cur, 'inverses': inv}
        chunk_ms.append(ms)
        chunk_launches.append(launches)
    differ = [(n, key) for n, e in mono.items() for key, t in e.items()
              if not torch.equal(t, cur['inverses'][n][key])]
    if differ:
        raise AssertionError(f'frozen window: {len(differ)} slots differ '
                             f'from the monolithic firing, first '
                             f'{differ[:3]}')
    out = {'slots': sum(len(e) for e in mono.values()),
           'monolithic_ms': mono_ms, 'chunk_ms': chunk_ms}
    if launch_key:
        got = [launches[launch_key] for launches in chunk_launches]
        if got != want or mono_launches[launch_key] != sum(want):
            raise AssertionError(
                f'frozen window: {launch_key} launches per chunk {got}, '
                f'monolithic {mono_launches[launch_key]}; the plan gives '
                f'{want} and {sum(want)}')
        out.update(launches_per_chunk=got,
                   monolithic_launches=mono_launches[launch_key])
    return out


def _factor_kernel_ms(state, x, y) -> dict:
    """Device ms of K1 and K2 in one profiled non-firing step of the
    config-5 run's ``state`` on the batch ``(x, y)``."""
    import functools
    import torch
    from torch.profiler import ProfilerActivity, profile
    from distributed_kfac_pytorch_tpu_torch.training import engine, utils
    criterion = functools.partial(utils.label_smooth_loss, smoothing=0.1)
    hyper = {'lr': R152_LR, 'damping': state.kfac.damping}
    flags = {'factor_update': True, 'inv_update': False}
    xb = torch.as_tensor(x, device='cuda')
    yb = torch.as_tensor(y, dtype=torch.long, device='cuda')
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.train_step(state, xb, yb, hyper, flags, criterion)
        torch.cuda.synchronize()
    out = {'K1 factor_ema': 0.0, 'K2 patch_cov': 0.0}
    for ev in prof.key_averages():
        dt = getattr(ev, 'self_device_time_total', None)
        if dt is None:
            dt = ev.self_cuda_time_total
        cat = _category(ev.key)
        if dt and ev.device_type.name == 'CUDA' and cat in out:
            out[cat] += dt / 1e3
    return out


def _schedule_run(label: str, card: str, buckets: int, c5: dict,
                  **knobs) -> dict:
    """Phase 23's config-5 run for SCHEDULE_STEPS steps with ``knobs``:
    the fired stages must be ``cadence_flags``', the loss finite and
    falling, the launches phase 23's, ``KFAC.memory_usage`` phase 23's
    state bytes; prints the plan and every step's ms with its stage."""
    def inspect(state):
        kfac, kst = state.kfac, state.kfac_state
        out = {'memory_usage': kfac.memory_usage(kst),
               'plan': _chunk_plan_summary(kfac, kst['factors'])}
        if 'frozen_factors' in kst:
            out['frozen_bytes'] = sum(
                t.numel() * t.element_size()
                for f in kst['frozen_factors'].values() for t in f.values())
        else:
            out['frozen_window'] = _frozen_window(kfac, kst)
        return out

    run = _r152_run(label, card, SCHEDULE_STEPS, buckets, inspect=inspect,
                    bf16_factors=True, **knobs)
    want = _schedule_fired(SCHEDULE_STEPS,
                           inv_pipeline_chunks=knobs['inv_pipeline_chunks'],
                           inv_staleness=knobs.get('inv_staleness', 0))
    if run['fired'] != want:
        raise AssertionError(f'{label}: fired {run["fired"]}, the schedule '
                             f'gives {want}')
    losses = run['losses']
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'{label}: loss did not decrease: first three '
                             f'{first:.4f}, last three {last:.4f}')
    ref = c5['bf16_factors']
    usage = run['memory_usage']
    if usage != {'factors': ref['factor_bytes'],
                 'inverses': ref['inverse_bytes']}:
        raise AssertionError(f'{label}: memory_usage {usage}, phase 23 '
                             f'{ref["factor_bytes"]} / '
                             f'{ref["inverse_bytes"]}')
    window = run['step_ms'][SCHEDULE_FREQ:2 * SCHEDULE_FREQ]
    amortized = (ref['nonfiring_ms_median'] * (SCHEDULE_FREQ - 1)
                 + ref['firing_ms'][0]) / SCHEDULE_FREQ
    run.update(window_max_ms=max(window),
               window_mean_ms=statistics.mean(window),
               phase23_firing_ms=ref['firing_ms'][0],
               phase23_amortized_ms=amortized,
               phase23_nonfiring_ms=ref['nonfiring_ms_median'])
    for row in run['plan']:
        log(f'    chunk {row["chunk"]}: {row["items"]} items, '
            f'{row["share"]:.1%} of the dim^3 proxy, matrices by dim '
            f'{row["matrices_by_dim"]}')
    log(f'  {label}: ms per step (stage): ' + ', '.join(
        f'{i}:{ms:.1f}' + (f'({f})' if f not in ('factor', None) else '')
        for i, (ms, f) in enumerate(zip(run['step_ms'], run['fired']))))
    log(f'  {label}: window {SCHEDULE_FREQ}-{2 * SCHEDULE_FREQ - 1}: '
        f'largest step {run["window_max_ms"]:.1f} ms against phase 23\'s '
        f'firing step {ref["firing_ms"][0]:.1f}; mean '
        f'{run["window_mean_ms"]:.2f} ms against phase 23\'s amortized '
        f'{amortized:.2f} (non-firing {ref["nonfiring_ms_median"]:.2f}); '
        f'memory_usage {usage["factors"] / 1e9:.3f} / '
        f'{usage["inverses"] / 1e9:.3f} GB = phase 23'
        + (f', snapshot {run["frozen_bytes"] / 1e9:.3f} GB'
           if 'frozen_bytes' in run else '') + f' ({card})')
    return run


def _r50_chunk_run(card: str) -> dict:
    """ResNet-50 under ``newton`` with SCHEDULE_CHUNKS chunks for
    R50_CHUNK_STEPS steps: K4 launches one per size bucket with a matrix
    in each fired chunk (step 0: every chunk's buckets), from the plan;
    then the frozen window from the final state, K4 per chunk."""
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    config = _r50_config(epochs=R50_CHUNK_STEPS, inverse_method='newton',
                         inv_pipeline_chunks=SCHEDULE_CHUNKS)
    _release()
    kernels.reset_launches()
    res = train_imagenet_resnet.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    state = res.pop('state')
    kfac, kst = state.kfac, state.kfac_state
    plan = kfac.inverse_chunk_plan(kst['factors'])
    per_chunk = [len({int(kst['factors'][k[1]][k[2]].shape[-1])
                      for k, c in plan.items() if c == j and k[0] == 'mat'})
                 for j in range(SCHEDULE_CHUNKS)]
    fired = res['fired']
    want_fired = _schedule_fired(R50_CHUNK_STEPS,
                                 inv_pipeline_chunks=SCHEDULE_CHUNKS)
    n = res['steps']
    expected = {name: per * n for name, per in R50_PER_STEP.items()}
    expected['ns_inverse'] = sum(per_chunk) + sum(
        per_chunk[int(f[len('chunk'):])] for f in fired
        if f and f.startswith('chunk'))
    expected['jacobi_eigh'] = 0
    if fired != want_fired or launches != expected or not all(
            math.isfinite(v) for v in res['losses']):
        raise AssertionError(f'resnet-50 newton, chunks: fired {fired}, '
                             f'launches {launches}, expected {expected}, '
                             f'losses {res["losses"]}')
    window = _frozen_window(kfac, kst, 'ns_inverse')
    del state
    _release()
    log(f'  resnet-50 newton, {SCHEDULE_CHUNKS} chunks: K4 buckets per '
        f'chunk {per_chunk}; launches {launches}; frozen window equal bit '
        f'for bit, monolithic {window["monolithic_ms"]:.1f} ms, chunks '
        f'{[round(t, 1) for t in window["chunk_ms"]]} ms ({card})')
    return {'launches': launches, 'buckets_per_chunk': per_chunk,
            'frozen_window': window, 'losses': res['losses'],
            'step_ms': res['step_ms'], 'fired': fired}


def _fraction_run(card: str, buckets: int, r152_ms: dict) -> dict:
    """Config 5 for 3 steps at FRACTION: phase 23's launches; K1 and K2
    device ms of one profiled step at FRACTION and at 1."""
    from distributed_kfac_pytorch_tpu_torch.training import datasets
    (x, y), _ = datasets.get_imagenet(synthetic_size=R50_BATCH)

    def inspect(state):
        thinned = _factor_kernel_ms(state, x, y)
        state.kfac.factor_batch_fraction = 1.0
        return {'kernel_ms': thinned,
                'kernel_ms_full': _factor_kernel_ms(state, x, y)}

    run = _r152_run(f'config 5, factor_batch_fraction {FRACTION}', card,
                    R152_SHORT_STEPS, buckets, inspect=inspect,
                    bf16_factors=True, factor_batch_fraction=FRACTION)
    got, full = run['kernel_ms'], run['kernel_ms_full']
    log(f'  fraction {FRACTION}: per step K1 {got["K1 factor_ema"]:.2f} ms,'
        f' K2 {got["K2 patch_cov"]:.2f} ms; the same step at fraction 1: '
        f'K1 {full["K1 factor_ema"]:.2f}, K2 {full["K2 patch_cov"]:.2f} '
        f'(phase 3 at config-5 shapes: K1 {r152_ms["factor_ema"]:.2f}, K2 '
        f'{r152_ms["patch_cov"]:.2f}); non-firing '
        f'{run["nonfiring_ms_median"]:.2f} ms ({card})')
    return run


def _xl_schedule(card: str) -> dict:
    """Phase 15's model with XL_SCHEDULE, 12 steps on one device, then in
    a one-rank NCCL group through ``DistributedKFAC``: the same fired
    stages (``cadence_flags``') and launches, losses bit for bit."""
    import torch.distributed as dist
    from distributed_kfac_pytorch_tpu_torch import launch
    single, launches, state = _run_tlm(
        'xl, chunks 2, deferred', _xl_config(**XL_SCHEDULE), XL_PER_STEP, 1)
    del state
    _release()
    store = _fresh_store('nccl_xl_schedule.store')
    launch.initialize_distributed(init_method=f'file://{store}', rank=0,
                                  world_size=1, device='cuda')
    try:
        if dist.get_backend() != 'nccl':
            raise AssertionError(f'backend {dist.get_backend()}, not nccl')
        nccl, nccl_launches, state = _run_tlm(
            'xl NCCL world 1, chunks 2, deferred',
            _xl_config(comm_method='comm-opt', **XL_SCHEDULE), XL_PER_STEP,
            1)
        kind = type(state.kfac).__name__
        del state
        _release()
    finally:
        dist.destroy_process_group()
    want = _schedule_fired(XL_STEPS, inv_pipeline_chunks=2,
                           deferred_reduce=True)
    if kind != 'DistributedKFAC' or single['fired'] != want \
            or nccl['fired'] != want or nccl_launches != launches:
        raise AssertionError(f'xl schedule: {kind}, fired {single["fired"]}'
                             f' / {nccl["fired"]} (want {want}), launches '
                             f'{launches} / {nccl_launches}')
    if nccl['losses'] != single['losses']:
        raise AssertionError(f'xl schedule: NCCL world 1 losses '
                             f'{nccl["losses"]} differ from the single '
                             f'device\'s {single["losses"]}')
    log(f'  xl, chunks 2, deferred: losses equal bit for bit in the NCCL '
        f'group; ms per step (stage) single device ' + ', '.join(
            f'{i}:{ms:.1f}' + (f'({f})' if f not in ('factor', None) else '')
            for i, (ms, f) in enumerate(zip(single['step_ms'],
                                            single['fired'])))
        + '; NCCL world 1 ' + ', '.join(
            f'{ms:.1f}' for ms in nccl['step_ms']) + f' ({card})')
    return {'losses': single['losses'], 'fired': single['fired'],
            'step_ms': single['step_ms'], 'nccl_step_ms': nccl['step_ms'],
            'launches': {k: launches[k] + nccl_launches[k]
                         for k in launches}}


def run_firing_schedule(card: str, r152: dict, c5: dict,
                        r152_ms: dict) -> dict:
    """Phase 25 (see the module docstring): ``c5`` is phase 23's report,
    ``r152_ms`` phase 3's K1 and K2 ms per config-5 step."""
    t0 = time.perf_counter()
    walls = {}

    def timed(key, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        walls[key] = round(time.perf_counter() - t, 1)
        return out

    buckets = len(r152['buckets'])
    chunks = timed('chunks', _schedule_run,
                   f'config 5, {SCHEDULE_CHUNKS} chunks', card, buckets, c5,
                   inv_pipeline_chunks=SCHEDULE_CHUNKS)
    window = chunks['frozen_window']
    log(f'  frozen window from the final state: {window["slots"]} slots '
        f'equal bit for bit; monolithic firing '
        f'{window["monolithic_ms"]:.1f} ms, chunks '
        f'{[round(t, 1) for t in window["chunk_ms"]]} ms')
    stale = timed('staleness', _schedule_run,
                  f'config 5, {SCHEDULE_CHUNKS} chunks, staleness 1', card,
                  buckets, c5, inv_pipeline_chunks=SCHEDULE_CHUNKS,
                  inv_staleness=1)
    r50 = timed('resnet50_newton', _r50_chunk_run, card)
    frac = timed('fraction', _fraction_run, card, buckets, r152_ms)
    xl = timed('transformer_xl', _xl_schedule, card)
    runs = (chunks, stale, r50, frac, xl)
    summary = {'chunks': chunks, 'staleness': stale, 'resnet50_newton': r50,
               'fraction': frac, 'transformer_xl': xl,
               'launches': {k: sum(r['launches'][k] for r in runs)
                            for k in chunks['launches']},
               'walls': walls, 'seconds': time.perf_counter() - t0}
    log(f'  phase 25: {summary["seconds"]:.1f} s wall ({walls})')
    return summary


# ---------------------------------------------------------------------------
# K5: the Jacobi eigh
# ---------------------------------------------------------------------------

def jacobi_work(n: int, count: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one K5 call: 9 n_pad^2 FLOPs per matrix and round
    over ``default_jacobi_sweeps(n) * (n_pad - 1)`` rounds; the stack read
    once, the eigenvectors and eigenvalues written once."""
    from distributed_kfac_pytorch_tpu_torch.ops import linalg
    n_pad = n + n % 2
    rounds = linalg.default_jacobi_sweeps(n) * (n_pad - 1) if n > 1 else 0
    return (4.0 * count * (2 * n * n + n),
            9.0 * n_pad * n_pad * rounds * count)


def _jacobi_errors(mats, q, d, d64) -> dict:
    """Eigenvalue error against ``d64`` (a float64 eigh) and the
    orthogonality and reconstruction errors of ``(q, d)``, each relative
    to the largest eigenvalue where the quantity scales with it."""
    import torch
    scale = max(float(d64.abs().max()), 1e-30)
    eye = torch.eye(q.shape[-1], dtype=torch.float64, device=q.device)
    q64, d_64 = q.double(), d.double()
    return {
        'eig': float((d_64 - d64).abs().max()) / scale,
        'orth': float((q64.mT @ q64 - eye).abs().max()),
        'recon': float(((q64 * d_64[:, None, :]) @ q64.mT
                        - mats.double()).abs().max()) / scale}


def _side_inverse(q, d):
    return (q * (1.0 / (d + JACOBI_DAMPING))[:, None, :]) @ q.mT


def jacobi_path_sizes() -> list[int]:
    """Edge sizes of K5's two paths, from ``jacobi_cluster_plan``: for
    each cluster size the largest ``n_pad`` that takes it (the last is the
    cluster path's capacity), then an odd size whose ``n_pad`` is just
    above the capacity (the streaming path)."""
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K
    largest = {}
    for n_pad in range(2, K.jacobi_cluster_capacity() + 1, 2):
        largest[K.jacobi_cluster_plan(n_pad, 2, 1).cluster] = n_pad
    cap = K.jacobi_cluster_capacity()
    assert K.jacobi_cluster_plan(cap + 2, 2, 1) is None
    return [largest[c] for c in sorted(largest)] + [cap + 1]


def jacobi_path(n: int, count: int) -> dict:
    """K5's path for a (count, n, n) stack: cluster size, max active
    clusters and waves per launch, or the streaming path."""
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K
    from distributed_kfac_pytorch_tpu_torch.ops import linalg
    n_pad = n + n % 2
    if n < 2:
        return {'path': 'none'}
    plan = K.jacobi_cluster_plan(
        n_pad, count, linalg.default_jacobi_sweeps(n) * (n_pad - 1))
    if plan is None:
        return {'path': 'streaming'}
    active = K.jacobi_max_active_clusters(n_pad)
    per = min(count, plan.chunk)
    return {'path': 'cluster', 'cluster': plan.cluster,
            'max_active_clusters': active,
            'waves': math.ceil(per / active) * math.ceil(count / per)}


def check_jacobi_eigh(quick: bool, defer_edges: bool = False) -> tuple:
    """K5 against its plain version at the LSTM LM's and ResNet-32's size
    buckets, the edge sizes of both paths and an identity stack. Returns
    the per-firing sums of the LSTM buckets and of the ResNet-32 ones, the
    rows, and, with ``defer_edges``, the untimed cases' inputs, drawn here
    in turn, for :func:`check_jacobi_edges` (else ``[]``)."""
    import torch
    gen = torch.Generator(device='cuda')
    gen.manual_seed(2)
    cases = [(f'LSTM ({c},{n},{n})', 'lstm', lambda n=n, c=c: _spd_stack(
        gen, c, n)) for n, c in LSTM_JACOBI_BUCKETS]
    cases += [(f'R32 ({c},{n},{n})', 'r32', lambda n=n, c=c: _spd_stack(
        gen, c, n)) for n, c in R32_JACOBI_BUCKETS]
    cases += [(f'edge (2,{n},{n})', None, lambda n=n: _spd_stack(gen, 2, n))
              for n in (*JACOBI_EDGE_SIZES, *jacobi_path_sizes())]
    cases.append(('identity (4,65,65)', None, lambda: torch.eye(
        65, device='cuda').expand(4, 65, 65).contiguous()))
    aggs = {group: {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
                    't_bytes': 0.0, 't_ops': 0.0, 'max_abs_err': 0.0}
            for group in ('lstm', 'r32')}
    rows, deferred = [], []
    for label, group, make in cases:
        f = make()
        if defer_edges and group is None:
            deferred.append((label, f))
            continue
        rows.append(_check_jacobi_case(label, group, f, quick, aggs))
        del f
    return aggs['lstm'], aggs['r32'], rows, deferred


def check_jacobi_edges(deferred: list) -> list:
    """Phase 8's untimed K5 cases (edge sizes and the identity stack) on
    the inputs :func:`check_jacobi_eigh` drew, held as there; they run
    beside phases 20 and 22, so their plain ms are those neighbours'.
    Returns the rows."""
    log('  phase 8, K5 edge sizes and the identity stack (beside phases 20 '
        'and 22):')
    return [_check_jacobi_case(label, None, f, True, {})
            for label, f in deferred]


def _check_jacobi_case(label: str, group, f, quick: bool,
                       aggs: dict) -> dict:
    """One K5 case against its plain version (see the module docstring);
    a case of a ``group`` is timed and summed into ``aggs`` unless
    ``quick``. Returns its row."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K
    count, n = f.shape[0], f.shape[-1]
    got_q, got_d = K.batched_jacobi_eigh(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_q, ref_d = K.batched_jacobi_eigh_plain(f)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.isfinite(got_q).all() and torch.isfinite(got_d).all()):
        raise AssertionError(f'jacobi_eigh {label}: non-finite output')
    d_scale = max(float(ref_d.abs().max()), 1e-30)
    d_abs = float((got_d - ref_d).abs().max())
    inv_got, inv_ref = _side_inverse(got_q, got_d), _side_inverse(
        ref_q, ref_d)
    inv_abs = float((inv_got - inv_ref).abs().max())
    inv_rel = inv_abs / float(inv_ref.abs().max())
    d64 = torch.linalg.eigvalsh(f.double())
    err = _jacobi_errors(f, got_q, got_d, d64)
    row = {'kernel': 'jacobi_eigh', 'case': label, 'n': n,
           'count': count, 'd_rel_err': d_abs / d_scale,
           'side_inverse_rel_err': inv_rel, 'orth': err['orth'],
           'recon': err['recon'], 'eig_vs_fp64': err['eig'],
           'plain_ms': plain_ms, 'q_max_abs_diff': float(
               (got_q - ref_q).abs().max()), **jacobi_path(n, count)}
    # Against the plain version: eigenvalues and the damped side inverse,
    # always.
    ok = row['d_rel_err'] <= 1e-5 and inv_rel <= 1e-4
    if err['orth'] > 5e-5 or err['recon'] > 5e-5:
        # fp32 drift of the algorithm over thousands of rounds: hold the
        # kernel to at most twice the plain version's own orthogonality
        # and reconstruction errors against float64.
        ref_err = _jacobi_errors(f, ref_q, ref_d, d64)
        row['plain_vs_fp64'] = ref_err
        row['rule'] = '2x plain vs fp64'
        ok = ok and all(err[k] <= 2 * max(ref_err[k], 1e-7)
                        for k in ('orth', 'recon'))
    if not ok:
        raise AssertionError(f'jacobi_eigh {label}: {row}')
    path = (f'C {row["cluster"]} active {row["max_active_clusters"]} '
            f'waves {row["waves"]}' if row['path'] == 'cluster'
            else row['path'])
    msg = (f'  jacobi_eigh {label:22s} d rel {row["d_rel_err"]:.1e} '
           f'inv rel {inv_rel:.1e} orth {err["orth"]:.1e} recon '
           f'{err["recon"]:.1e} |dQ| {row["q_max_abs_diff"]:.1e} '
           f'(exactly 0: {row["q_max_abs_diff"] == 0.0}) [{path}] '
           f'plain {plain_ms:.1f} ms')
    if not quick and group is not None:
        reps, trials, warm = (1, 3, 1) if n >= 500 else (3, 3, 1)
        row['ms'] = time_ms(lambda: K.batched_jacobi_eigh(f), reps,
                            trials, warm)
        row['library_ms'] = time_ms(lambda: torch.linalg.eigh(f), reps,
                                    trials, warm)
        nbytes, flops = jacobi_work(n, count)
        row['bound_ms'], row['bound_by'] = bound(nbytes, flops)
        agg = aggs[group]
        for key in ('ms', 'plain_ms', 'library_ms'):
            agg[key] += row[key]
        agg['t_bytes'] += nbytes / PEAK_BYTES * 1e3
        agg['t_ops'] += flops / PEAK_FP32_FLOPS * 1e3
        agg['max_abs_err'] = max(agg['max_abs_err'], d_abs, inv_abs)
        msg += (f'  ms {row["ms"]:.2f} lib (eigh) '
                f'{row["library_ms"]:.2f} bound {row["bound_ms"]:.3f} '
                f'({row["bound_by"]})')
    log(msg)
    return row


def _lm_config(**over) -> dict:
    config = {'synthetic_vocab': 10000, 'fixed_batch': True, 'epochs': 1,
              'max_steps': LM_STEPS, 'seed': 0, 'time_steps': True,
              'quiet': True}
    config.update(over)
    return config


def _run_lm(config: dict) -> tuple[dict, dict, list]:
    from distributed_kfac_pytorch_tpu_torch import train_language_model
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    kernels.reset_launches()
    res = train_language_model.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    res.pop('state')
    losses = res['losses']
    if len(losses) != config['max_steps'] or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f'LM: losses {losses}')
    return res, launches, losses


def run_lstm_jacobi(card: str) -> dict:
    """Phase 9: 12 LSTM LM steps under eigen + jacobi."""
    res, launches, losses = _run_lm(_lm_config(inverse_method='eigen',
                                               eigh_method='jacobi'))
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    log(f'  losses: {[round(v, 4) for v in losses]}')
    if not last < first:
        raise AssertionError(f'LSTM loss did not decrease: first three '
                             f'{first:.4f}, last three {last:.4f}')
    firings = res['fired'].count('inverse')
    if firings != 2:
        raise AssertionError(f'LSTM: fired {res["fired"]}')
    expected = {name: per * LM_STEPS for name, per in LM_PER_STEP.items()}
    expected['jacobi_eigh'] = LM_JACOBI_PER_FIRING * firings
    if launches != expected:
        raise AssertionError(f'LSTM: launches {launches}, expected '
                             f'{expected}')
    firing, plain = _step_ms(res)
    summary = {'steps': LM_STEPS, 'losses': losses, 'loss_first3': first,
               'loss_last3': last, 'firings': firings,
               'launches': launches, 'firing_ms': firing,
               'step0_ms': res['step_ms'][0],
               'nonfiring_ms_median': statistics.median(plain),
               'nonfiring_ms': plain, 'val': res['val']}
    log(f'  loss first three {first:.4f} -> last three {last:.4f}; '
        f'launches {launches}; val ppl {res["val"]["ppl"]:.1f}')
    log(f'  ms/step: non-firing {summary["nonfiring_ms_median"]:.2f} '
        f'(median), firing {[round(t, 1) for t in firing]} (step 0: '
        f'{res["step_ms"][0]:.1f}) ({card})')
    return summary


def run_lm_defaults(card: str) -> dict:
    """Phase 10: 3 steps of the LM CLI's defaults (auto: Cholesky)."""
    res, launches, losses = _run_lm(_lm_config(max_steps=3))
    expected = {name: per * 3 for name, per in LM_PER_STEP.items()}
    expected['jacobi_eigh'] = 0
    if launches != expected or res['fired'].count('inverse') != 1:
        raise AssertionError(f'LM defaults: launches {launches} (expected '
                             f'{expected}), fired {res["fired"]}')
    summary = {'losses': losses, 'launches': launches,
               'firing_ms': res['step_ms'][0],
               'nonfiring_ms': res['step_ms'][1:]}
    log(f'  losses {[round(v, 4) for v in losses]}; launches {launches}; '
        f'firing step (step 0) {res["step_ms"][0]:.1f} ms, non-firing '
        f'{[round(t, 2) for t in res["step_ms"][1:]]} ms ({card})')
    return summary


def run_resnet32_jacobi(card: str) -> dict:
    """Phase 11: 11 ResNet-32 steps under --eigh-method jacobi."""
    from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    config = {'model': 'resnet32', 'batch_size': 128,
              'synthetic_size': 128, 'val_batch_size': 32,
              'epochs': R32_JACOBI_STEPS, 'no_augment': True, 'seed': 0,
              'kfac_update_freq': 10, 'kfac_cov_update_freq': 1,
              'eigh_method': 'jacobi', 'time_steps': True, 'quiet': True}
    kernels.reset_launches()
    res = train_cifar10_resnet.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    res.pop('state')
    losses, n = res['losses'], res['steps']
    if n != R32_JACOBI_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'ResNet-32 jacobi: {n} steps, losses {losses}')
    firings = res['fired'].count('inverse')
    expected = {name: per * n for name, per in EXPECTED_PER_STEP.items()}
    expected['jacobi_eigh'] = R32_JACOBI_PER_FIRING * firings
    if launches != expected:
        raise AssertionError(f'ResNet-32 jacobi: launches {launches}, '
                             f'expected {expected}')
    firing, plain = _step_ms(res)
    summary = {'losses': losses, 'launches': launches, 'firings': firings,
               'firing_ms': firing, 'step0_ms': res['step_ms'][0],
               'nonfiring_ms_median': statistics.median(plain)}
    log(f'  losses {[round(v, 4) for v in losses]}; launches {launches}')
    log(f'  ms/step: non-firing {summary["nonfiring_ms_median"]:.2f} '
        f'(median), firing {[round(t, 1) for t in firing]} ({card})')
    return summary


# ---------------------------------------------------------------------------
# Phases 13-14: distributed K-FAC (parallel.DistributedKFAC)
# ---------------------------------------------------------------------------

def _fresh_store(name: str) -> Path:
    """A ``file://`` rendezvous path under chiprun_out (must not exist)."""
    out = ROOT / 'chiprun_out'
    out.mkdir(exist_ok=True)
    path = out / name
    path.unlink(missing_ok=True)
    return path


def run_resnet50_nccl(card: str, r50: dict) -> dict:
    """Phase 13: phase 6's run through ``train_imagenet_resnet.train``
    inside a one-rank NCCL group (``--comm-method comm-opt``): the same
    losses within 1e-3, the same launches, step times beside phase 6's."""
    import torch.distributed as dist
    from distributed_kfac_pytorch_tpu_torch import launch, \
        train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    store = _fresh_store('nccl_world1.store')
    launch.initialize_distributed(init_method=f'file://{store}', rank=0,
                                  world_size=1, device='cuda')
    try:
        if dist.get_backend() != 'nccl':
            raise AssertionError(f'backend {dist.get_backend()}, not nccl')
        config = _r50_config(epochs=R50_STEPS, inverse_method='newton',
                             comm_method='comm-opt')
        kernels.reset_launches()
        res = train_imagenet_resnet.train(config, device='cuda')
        launches = dict(kernels.LAUNCHES)
        state = res.pop('state')
        shared = _nccl_shared_inputs()
    finally:
        dist.destroy_process_group()
    if type(state.kfac).__name__ != 'DistributedKFAC' or \
            not state.distributed:
        raise AssertionError('phase 13 did not run DistributedKFAC')
    losses, n = res['losses'], res['steps']
    log(f'  losses: {[round(v, 4) for v in losses]}')
    if n != R50_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'NCCL world 1: {n} steps, losses {losses}')
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, r50['losses'])]
    if max(rel[:R50_NCCL_HELD]) > 1e-3:
        raise AssertionError(f'NCCL world 1: losses of steps 0-'
                             f'{R50_NCCL_HELD - 1} differ from phase 6 by '
                             f'{[f"{r:.2e}" for r in rel[:R50_NCCL_HELD]]} '
                             'relative (limit 1e-3)')
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    last6 = statistics.mean(r50['losses'][-3:])
    if abs(last - last6) > R50_NCCL_FINAL_TOL * last6:
        raise AssertionError(f'NCCL world 1: last three losses {last:.4f} '
                             f'against phase 6\'s {last6:.4f} (limit '
                             f'{R50_NCCL_FINAL_TOL} relative)')
    if not last < first:
        raise AssertionError(f'NCCL world 1: loss did not decrease: first '
                             f'three {first:.4f}, last three {last:.4f}')
    firings = res['fired'].count('inverse')
    expected = {name: per * n for name, per in R50_PER_STEP.items()}
    expected['ns_inverse'] = R50_PER_FIRING * firings
    expected['jacobi_eigh'] = 0
    if launches != expected:
        raise AssertionError(f'NCCL world 1: launches {launches}, expected '
                             f'{expected}')
    firing, plain = _step_ms(res)
    summary = {'losses': losses, 'rel_loss_vs_phase6': rel,
               'shared_inputs': shared,
               'launches': launches, 'firings': firings,
               'firing_ms': firing, 'nonfiring_ms': plain,
               'nonfiring_ms_median': statistics.median(plain),
               'phase6_nonfiring_ms_median': r50['nonfiring_ms_median'],
               'phase6_firing_ms': r50['firing_ms']}
    log(f'  relative to phase 6 per step: {[f"{r:.1e}" for r in rel]}; '
        f'launches {launches}')
    log(f'  ms/step, NCCL world 1: non-firing '
        f'{summary["nonfiring_ms_median"]:.2f} (median), firing '
        f'{[round(t, 2) for t in firing]}; phase 6 (single device): '
        f'{r50["nonfiring_ms_median"]:.2f}, '
        f'{[round(t, 2) for t in r50["firing_ms"]]} ({card})')
    return summary


def _nccl_shared_inputs() -> dict:
    """Phase 13's per-step check, inside its NCCL group: ResNet-50 as in
    phase 6 (224 px, batch 64, ``newton``, factors every step, inverses
    every 10, 12 steps), one capture per step feeding both the
    single-device ``KFAC`` and ``DistributedKFAC`` (COMM_OPT), the model
    stepped with the single-device result; every step's factors,
    preconditioned gradients and KL-clip scale held against it
    (``STEP_TOL``, relative to the largest reference entry)."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.models import imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import datasets, utils
    dev = torch.device('cuda')
    (x, y), _ = datasets.get_imagenet(synthetic_size=R50_BATCH)
    x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(0)
        model = imagenet_resnet.get_model('resnet50').to(dev)
    knobs = dict(damping=0.001, factor_update_freq=1,
                 inv_update_freq=R50_FIRE_EVERY, kl_clip=0.001, lr=R50_LR,
                 inverse_method='newton', device=dev)
    ref = KFAC(model, **knobs)
    dk = DistributedKFAC(KFAC(model, **knobs), comm_method='comm-opt')
    ref_state, dk_state = ref.init_state(), dk.init_state()
    errors, failures = [], []
    for step in range(R50_STEPS):
        inv = step % R50_FIRE_EVERY == 0
        _, _, grads, captures = ref.capture.loss_and_grads(
            lambda out: utils.label_smooth_loss(out, y, smoothing=0.1), x)
        p_ref, ref_state = ref.step(ref_state, grads, captures,
                                    factor_update=True, inv_update=inv)
        p_dk, dk_state = dk.step(dk_state, grads, captures,
                                 factor_update=True, inv_update=inv)
        err = {'factors': _max_rel(
                   (dk_state['factors'][n][s], ref_state['factors'][n][s])
                   for n in ref.specs for s in 'AG'),
               'precond': _max_rel((p_dk[n], p_ref[n]) for n in p_ref),
               'nu': _max_rel([(dk.last_nu, ref.last_nu)])}
        errors.append(err)
        bad = {k: v for k, v in err.items()
               if not v <= STEP_TOL[k]}
        if bad:
            failures.append(f'step {step}: {bad}')
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= R50_LR * p_ref[n]
    ref.capture.close()
    dk.kfac.capture.close()
    worst = {k: max(e[k] for e in errors) for k in STEP_TOL}
    log(f'  shared inputs, {R50_STEPS} steps, DistributedKFAC (NCCL, world '
        f'1) vs single-device KFAC, worst: factors {worst["factors"]:.2e}, '
        f'preconditioned grads {worst["precond"]:.2e}, nu '
        f'{worst["nu"]:.2e} (limits {STEP_TOL})')
    if failures:
        raise AssertionError(f'NCCL world 1, shared inputs: {failures}')
    return {'errors': errors, 'worst': worst}


# (name, comm method, grad-worker fraction, eigh method, expected grid)
GLOO_CASES = (('comm_opt', 'comm-opt', 0.0, 'xla', (1, 4)),
              ('mem_opt', 'mem-opt', 0.0, 'xla', (4, 1)),
              ('hybrid_opt', 'hybrid-opt', 0.5, 'xla', (2, 2)),
              ('hybrid_opt_jacobi', 'hybrid-opt', 0.5, 'jacobi', (2, 2)))
GLOO_WORLD, GLOO_BATCH, GLOO_STEPS, GLOO_INV_FREQ = 4, 128, 3, 2


def _max_rel(pairs) -> float:
    """Largest per-tensor ``max|a - b| / max|b|`` over ``(a, b)`` pairs."""
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in pairs)


def _bf16_gap(got: dict, want: dict) -> tuple[int, bool]:
    """Two ``{layer: {'A', 'G'}}`` bf16 factor sets: the largest distance
    in bf16 ulps, and whether every entry is within 1 ulp or, where that
    is more, within 1e-5 of its factor's largest entry (phase 14's fp32
    tolerance: sums taken in another order move an entry that cancels to
    near zero by more than an ulp of itself)."""
    import torch

    def keys(t):
        b = t.view(torch.int16).to(torch.int32)
        return torch.where(b < 0, -(b & 0x7FFF), b)
    worst, ok = 0, True
    for name, f in want.items():
        for side, w in f.items():
            g = got[name][side]
            gap = (keys(g) - keys(w)).abs()
            diff = (g.float() - w.float()).abs()
            worst = max(worst, int(gap.max()))
            ok &= bool(((gap <= 1) | (diff <= 1e-5 * w.float().abs().max())
                        ).all())
    return worst, ok


def _gloo_resnet32(cfg: dict, timeout: float) -> tuple:
    """A gloo rank of phases 14, 24 and 26 on ``cuda:0`` (collectives time
    out after ``timeout`` seconds), and its data: ``(rank, device, x, y,
    local slice, model, initial state_dict)`` for ResNet-32 at full width
    on one global batch of GLOO_BATCH."""
    import torch
    from distributed_kfac_pytorch_tpu_torch import launch, \
        set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet

    set_fp32_precision()
    meta = launch.initialize_distributed(
        init_method=f'file://{cfg["store"]}', backend='gloo',
        device='cuda:0', timeout=timeout)
    dev = torch.device('cuda:0')
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(GLOO_BATCH, 3, 32, 32, generator=gen).to(dev)
    y = torch.randint(0, 10, (GLOO_BATCH,), generator=gen).to(dev)
    local = launch.process_local_slice(GLOO_BATCH)
    torch.manual_seed(0)
    model = cifar_resnet.get_model('resnet32').to(dev)
    # BatchNorm in eval mode, with running statistics set from one pass
    # over the global batch (the same on every rank): each rank's slice is
    # then normalized as in the full batch. Left at their initial (0, 1)
    # the 15 residual blocks grow the head's inputs until its A factor's
    # condition number is ~1e5 and the loss ~600.
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_running_stats()
            mod.momentum = None
    with torch.no_grad():
        model(x)
    model.eval()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    return meta['process_index'], dev, x, y, local, model, init


def dist_worker(cfg: dict) -> int:
    """One rank of phase 14 (``chip_smoke.py --dist-worker CONFIG``):
    ResNet-32 at full width, BatchNorm in eval mode, this rank's slice of
    one global batch, every case of GLOO_CASES in turn; rank 0 holds each
    step against the single-device KFAC on the full batch. Phase 24
    (``'resnet32_bf16'``) runs the first three cases with the three bf16
    flags: rank 0 also takes one factor step of the single-device KFAC
    from the world's factors before each step and holds the world's new
    factors to it in bf16 ulps (:func:`_bf16_gap`), and holds the
    preconditioned gradients and KL-clip scale at ``BF16_STEP_TOL``."""
    import torch
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine
    import torch.distributed as dist

    rank, dev, x, y, local, model, init = _gloo_resnet32(cfg, 600)
    knobs = dict(inverse_method='eigen', factor_update_freq=1,
                 inv_update_freq=GLOO_INV_FREQ, damping=0.003, lr=0.1,
                 kl_clip=0.001, device=dev)
    bf16 = cfg['phase'] == 'resnet32_bf16'
    cases = GLOO_CASES[:3] if bf16 else GLOO_CASES
    if bf16:
        knobs.update(dict.fromkeys(
            ('factor_dtype', 'factor_compute_dtype', 'inv_dtype',
             'precond_compute_dtype'), torch.bfloat16))
    tol = BF16_STEP_TOL if bf16 else STEP_TOL
    report = {'rank': rank, 'cases': []}
    failures = []
    # Phase 14 carries the on-device metrics (both sides), every rank a
    # sink at one path: only rank 0's writes.
    stream = None
    if not bf16:
        from distributed_kfac_pytorch_tpu_torch.observability import \
            metrics as obs_metrics
        from distributed_kfac_pytorch_tpu_torch.observability import \
            sink as obs_sink
        knobs['collect_metrics'] = True
        stream = obs_sink.JsonlMetricsSink(
            str(Path(cfg['store']).with_suffix('.jsonl')),
            process_index=rank, meta={'rank': rank})
    records = 0
    for name, comm, frac, eigh, grid in cases:
        model.load_state_dict(init)
        kfac = KFAC(model, eigh_method=eigh, **knobs)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)
        work = dk.local_work()
        state = dk.init_state()
        ref = ref_state = None
        if rank == 0:
            ref = KFAC(model, eigh_method=eigh, **knobs)
            ref_state = ref.init_state()
        launches = dict.fromkeys(kernels.LAUNCHES, 0)
        errors, step_ms = [], []
        firings = 0
        for step in range(GLOO_STEPS):
            inv = step % GLOO_INV_FREQ == 0
            firings += inv
            torch.cuda.synchronize()
            dist.barrier()     # rank 0's reference check runs between steps
            kernels.reset_launches()
            prev = state['factors']
            t0 = time.perf_counter()
            _, _, grads, captures = kfac.capture.loss_and_grads(
                lambda out: F.cross_entropy(out, y[local]), x[local])
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, state = dk.step(state, grads, captures,
                                     factor_update=True, inv_update=inv)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
            if rank == 0:
                _, _, g_full, c_full = ref.capture.loss_and_grads(
                    lambda out: F.cross_entropy(out, y), x)
                if bf16:
                    shared = ref.update_factors({'factors': prev}, c_full)
                p_ref, ref_state = ref.step(ref_state, g_full, c_full,
                                            factor_update=True,
                                            inv_update=inv)
                err = {
                    'precond': _max_rel((precond[n], p_ref[n])
                                        for n in p_ref),
                    'nu': _max_rel([(dk.last_nu, ref.last_nu)])}
                if bf16:
                    err['shared_ulps'], ok = _bf16_gap(state['factors'],
                                                       shared)
                    err['run_ulps'] = _bf16_gap(state['factors'],
                                                ref_state['factors'])[0]
                    if not ok:
                        failures.append(
                            f'{name} step {step}: factors from the shared '
                            f'state {err["shared_ulps"]} ulps apart, over '
                            '1 ulp (and 1e-5 of the largest entry)')
                else:
                    err['factors'] = _max_rel(
                        (state['factors'][n][s], ref_state['factors'][n][s])
                        for n in ref.specs for s in 'AG')
                if stream is not None:
                    err.update(_metric_errors(state['metrics'],
                                              ref_state['metrics']))
                    if err.pop('counters') != 'equal':
                        failures.append(f'{name} step {step}: metric '
                                        'counters differ from the single '
                                        'device\'s')
                errors.append(err)
                bad = {k: v for k, v in err.items()
                       if k in tol and not v <= tol[k]
                       or k in METRIC_TOL and not v <= METRIC_TOL[k]}
                if bad:
                    failures.append(f'{name} step {step}: {bad}')
            if stream is not None:
                stream.step_record(records, obs_metrics.flatten_metrics(
                    state['metrics']))
                records += 1
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p -= 0.1 * precond[n]
        expected = dict.fromkeys(kernels.LAUNCHES, 0)
        expected.update({
            'factor_ema': R32_PER_STEP_K1 * GLOO_STEPS,
            'patch_cov': R32_PER_STEP_K2 * GLOO_STEPS,
            'bucket_precond': len(work['precondition']) * GLOO_STEPS})
        if eigh == 'jacobi':
            expected['jacobi_eigh'] = len(work['decompose']) * firings
            if work['decompose'] and not launches['jacobi_eigh']:
                failures.append(f'{name}: rank {rank} holds slots but '
                                'launched no K5')
        if launches != expected:
            failures.append(f'{name}: rank {rank} launches {launches}, '
                            f'expected {expected} from the assignment')
        if (dk.n_rows, dk.n_cols) != grid:
            failures.append(f'{name}: grid {(dk.n_rows, dk.n_cols)}')
        report['cases'].append({
            'name': name, 'grid': [dk.n_rows, dk.n_cols],
            'row': dk.row, 'col': dk.col, 'work': {
                'decompose': work['decompose'],
                'precondition': [list(s) for s in work['precondition']]},
            'launches': launches, 'expected': expected,
            'errors': errors, 'step_ms': step_ms})
        kfac.capture.close()
        if ref is not None:
            ref.capture.close()
    if stream is not None:
        stream.close()
    report['failures'] = failures
    Path(cfg['out']).write_text(json.dumps(report, indent=1))
    dist.destroy_process_group()
    return 1 if failures else 0


def _metric_errors(got: dict, want: dict) -> dict:
    """A rank's ``DistributedKFAC`` metrics against the single-device
    ``KFAC``'s of the same step: ``metrics_nu`` (the largest relative gap
    of ``nu`` and the gradient norm), ``metrics_norms`` (of the
    preconditioned norm and every bucket norm), ``eig_clipped`` of both
    and ``counters``: 'equal' when every count (clipped eigenvalues
    included) is the single device's."""
    def rel(a, b):
        return float((a - b).abs() / b.abs().clamp_min(1e-30))
    counts = ('factor_updates', 'inv_updates', 'inv_chunk_firings',
              'nonfinite_skips', 'eig_clipped')
    return {
        'metrics_nu': max(rel(got[k], want[k])
                          for k in ('nu', 'grad_norm')),
        'metrics_norms': max([rel(got['precond_norm'],
                                  want['precond_norm'])]
                             + [rel(got['bucket_norms'][k], v)
                                for k, v in want['bucket_norms'].items()]),
        'eig_clipped': [int(got['eig_clipped']), int(want['eig_clipped'])],
        'counters': ('equal' if all(int(got[k]) == int(want[k])
                                    for k in counts) else 'differ')}


def _run_gloo_ranks(phase: str, timeout: float = 900) -> list:
    """GLOO_WORLD ranks of ``phase`` (``'resnet32'`` and
    ``'resnet32_bf16'``: :func:`dist_worker`, ``'lm'``:
    :func:`lm_dist_worker`, ``'resnet32_overlap'``:
    :func:`overlap_dist_worker`) on the one card, subprocesses of this
    script, each given ``timeout`` seconds; returns their reports,
    failing if any rank fails."""
    store = _fresh_store(f'gloo_{phase}.store')
    outs = [_fresh_store(f'gloo_{phase}_rank{r}.json')
            for r in range(GLOO_WORLD)]
    procs = []
    for rank in range(GLOO_WORLD):
        cfg = json.dumps({'phase': phase, 'store': str(store),
                          'out': str(outs[rank])})
        env = {**os.environ, 'RANK': str(rank),
               'WORLD_SIZE': str(GLOO_WORLD), 'LOCAL_RANK': '0'}
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / 'chip_smoke.py'), '--dist-worker',
             cfg], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = [json.loads(o.read_text()) if o.exists() else None
               for o in outs]
    for rank, (p, rep) in enumerate(zip(procs, reports)):
        if p.returncode != 0 or rep is None:
            log(logs[rank][-4000:])
            raise AssertionError(
                f'gloo {phase} rank {rank}: exit {p.returncode}; '
                f'{rep["failures"] if rep else "no report"}')
    return reports


def _launch_total(reports) -> dict:
    """Launches summed over every rank and case of a gloo world."""
    total = dict.fromkeys(reports[0]['cases'][0]['launches'], 0)
    for rep in reports:
        for case in rep['cases']:
            for k, v in case['launches'].items():
                total[k] += v
    return total


def run_bf16_gloo_world(card: str) -> dict:
    """Phase 24: phase 14's ranks with the three bf16 flags under COMM_OPT,
    MEM_OPT and HYBRID_OPT; fails if any rank fails."""
    t0 = time.perf_counter()
    log(f'  phase 24: ResNet-32, {GLOO_WORLD} ranks on one card over gloo, '
        '--bf16-factors --bf16-inverses --bf16-precond, 3 mesh cases x '
        f'{GLOO_STEPS} steps')
    reports = _run_gloo_ranks('resnet32_bf16')
    worst = {}
    for i, case in enumerate(reports[0]['cases']):
        errs = case['errors']
        worst[case['name']] = {k: max(e[k] for e in errs) for k in errs[0]}
        w = worst[case['name']]
        log(f'  {case["name"]} grid {case["grid"]}, bf16 factors, inverses '
            f'and precond: rank 0 vs single-device KFAC over '
            f'{len(errs)} steps: factors from the shared state '
            f'{w["shared_ulps"]} ulp(s) at most, across the runs '
            f'{w["run_ulps"]}; preconditioned grads {w["precond"]:.2e}, nu '
            f'{w["nu"]:.2e} (limits {BF16_STEP_TOL})')
        for rep in reports:
            c = rep['cases'][i]
            log(f'    rank {rep["rank"]} (row {c["row"]}, col {c["col"]}): '
                f'launches { {k: v for k, v in c["launches"].items() if v} }'
                f' = assignment; step ms (gloo through host memory) '
                f'{[round(t, 1) for t in c["step_ms"]]}')
    total = _launch_total(reports)
    seconds = time.perf_counter() - t0
    log(f'  all ranks: launches {total}; phase 24: {seconds:.1f} s wall '
        f'({card})')
    return {'launches': total, 'worst': worst, 'ranks': reports,
            'seconds': seconds}


# Phase 26: phase 14's ranks under the firing-schedule knobs, inverses
# every 4 (chunk 0 at phase 1, chunk 1 at phase 3, snapshots and the
# deferred reduction at the window heads), 9 steps.
OVERLAP_GLOO_CASES = (  # (name, comm_method, fraction, knobs, grid)
    ('hybrid_opt_newton', 'hybrid-opt', 0.5, {'inverse_method': 'newton'},
     (2, 2)),
    ('mem_opt_jacobi', 'mem-opt', 0.0,
     {'inverse_method': 'eigen', 'eigh_method': 'jacobi'}, (4, 1)))
OVERLAP_KNOBS = {'inv_pipeline_chunks': 2, 'inv_staleness': 1,
                 'deferred_factor_reduction': True}
OVERLAP_STEPS, OVERLAP_INV_FREQ, OVERLAP_TIMEOUT = 9, 4, 300


def overlap_dist_worker(cfg: dict) -> int:
    """One rank of phase 26 (``chip_smoke.py --dist-worker CONFIG``):
    ResNet-32 as phase 14 runs it, every case of OVERLAP_GLOO_CASES with
    OVERLAP_KNOBS. Each step's K4 / K5 launches must equal
    ``DistributedKFAC.firing_launches`` of its firing; rank 0 holds every
    step against the single-device ``KFAC`` with the same knobs on the
    full batch, firing the grid's chunk plan (``item_chunk_plan``); every
    step's factor digest goes into the report."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine

    rank, dev, x, y, local, model, init = _gloo_resnet32(cfg, 120)
    common = dict(factor_update_freq=1, inv_update_freq=OVERLAP_INV_FREQ,
                  damping=0.003, lr=0.1, kl_clip=0.001, device=dev,
                  **OVERLAP_KNOBS)
    report = {'rank': rank, 'cases': []}
    failures = []
    for name, comm, frac, knobs, grid in OVERLAP_GLOO_CASES:
        model.load_state_dict(init)
        kfac = KFAC(model, **common, **knobs)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)
        work = dk.local_work()
        decompose = ('jacobi_eigh' if knobs.get('eigh_method') == 'jacobi'
                     else 'ns_inverse')
        state = dk.init_state()
        ref = ref_state = None
        if rank == 0:
            ref = KFAC(model, **common, **knobs)
            plan = dk.item_chunk_plan()
            ref.inverse_chunk_plan = lambda factors: plan
            ref_state = ref.init_state()
        launches = dict.fromkeys(kernels.LAUNCHES, 0)
        errors, step_ms, digests, fired, firing_launches = [], [], [], [], []
        for step in range(OVERLAP_STEPS):
            flags = engine.kfac_step_flags(engine.cadence_flags(
                step, 1, OVERLAP_INV_FREQ, OVERLAP_KNOBS['inv_pipeline_chunks'],
                deferred_reduce=True, inv_staleness=1))
            torch.cuda.synchronize()
            dist.barrier()     # rank 0's reference check runs between steps
            kernels.reset_launches()
            t0 = time.perf_counter()
            _, _, grads, captures = kfac.capture.loss_and_grads(
                lambda out: F.cross_entropy(out, y[local]), x[local])
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, state = dk.step(state, grads, captures, **flags)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            fired.append(engine.fired_stage(flags))
            digests.append(_digest(state['factors']))
            want = (dk.firing_launches() if flags['inv_update'] else
                    dk.firing_launches(flags['inv_chunk'])
                    if 'inv_chunk' in flags else 0)
            firing_launches.append(kernels.LAUNCHES[decompose])
            if kernels.LAUNCHES[decompose] != want:
                failures.append(f'{name} step {step} ({fired[-1]}): rank '
                                f'{rank} {decompose} launches '
                                f'{kernels.LAUNCHES[decompose]}, its '
                                f'assignment and the plan give {want}')
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
            if rank == 0:
                _, _, g_full, c_full = ref.capture.loss_and_grads(
                    lambda out: F.cross_entropy(out, y), x)
                p_ref, ref_state = ref.step(ref_state, g_full, c_full,
                                            **flags)
                err = {'factors': _max_rel(
                           (state['factors'][n][s], ref_state['factors'][n][s])
                           for n in ref.specs for s in 'AG'),
                       'precond': _max_rel((precond[n], p_ref[n])
                                           for n in p_ref),
                       'nu': _max_rel([(dk.last_nu, ref.last_nu)])}
                errors.append(err)
                bad = {k: v for k, v in err.items() if not v <= STEP_TOL[k]}
                if bad:
                    failures.append(f'{name} step {step}: {bad}')
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p -= 0.1 * precond[n]
        expected = dict.fromkeys(kernels.LAUNCHES, 0)
        expected.update({
            'factor_ema': R32_PER_STEP_K1 * OVERLAP_STEPS,
            'patch_cov': R32_PER_STEP_K2 * OVERLAP_STEPS,
            'bucket_precond': len(work['precondition']) * OVERLAP_STEPS,
            decompose: sum(firing_launches)})
        if launches != expected:
            failures.append(f'{name}: rank {rank} launches {launches}, '
                            f'expected {expected}')
        if (dk.n_rows, dk.n_cols) != grid:
            failures.append(f'{name}: grid {(dk.n_rows, dk.n_cols)}')
        report['cases'].append({
            'name': name, 'grid': [dk.n_rows, dk.n_cols], 'row': dk.row,
            'col': dk.col, 'fired': fired, 'launches': launches,
            'firing_launches': firing_launches, 'digests': digests,
            'errors': errors, 'step_ms': step_ms})
        kfac.capture.close()
        if ref is not None:
            ref.capture.close()
    report['failures'] = failures
    Path(cfg['out']).write_text(json.dumps(report, indent=1))
    dist.destroy_process_group()
    return 1 if failures else 0


def run_overlap_gloo_world(card: str) -> dict:
    """Phase 26: GLOO_WORLD ranks of :func:`overlap_dist_worker`, each
    under OVERLAP_TIMEOUT; fails if any rank fails or two ranks' factor
    digests differ at any step."""
    log(f'  phase 26: the firing schedule distributed, ResNet-32, '
        f'{GLOO_WORLD} ranks on one card over gloo, chunks 2, staleness 1, '
        f'deferred reduction, {len(OVERLAP_GLOO_CASES)} cases x '
        f'{OVERLAP_STEPS} steps')
    t0 = time.perf_counter()
    reports = _run_gloo_ranks('resnet32_overlap', timeout=OVERLAP_TIMEOUT)
    worst = {}
    for i, case in enumerate(reports[0]['cases']):
        name = case['name']
        digests = {rep['rank']: rep['cases'][i]['digests']
                   for rep in reports}
        if any(d != digests[0] for d in digests.values()):
            raise AssertionError(f'{name}: ranks\' factors differ: '
                                 f'{digests}')
        errs = case['errors']
        worst[name] = {k: max(e[k] for e in errs) for k in STEP_TOL}
        w = worst[name]
        log(f'  {name} grid {case["grid"]}, stages {case["fired"]}: rank 0 '
            f'vs single-device KFAC on the grid\'s plan, worst of '
            f'{len(errs)} steps: factors {w["factors"]:.2e}, gradients '
            f'{w["precond"]:.2e}, nu {w["nu"]:.2e}; factors equal on every '
            'rank at every step (digests)')
        for rep in reports:
            c = rep['cases'][i]
            log(f'    rank {rep["rank"]} (row {c["row"]}, col {c["col"]}): '
                f'decomposition launches per step {c["firing_launches"]} = '
                f'assignment and plan; step ms (gloo through host memory) '
                f'{[round(t, 1) for t in c["step_ms"]]}')
    total = _launch_total(reports)
    seconds = time.perf_counter() - t0
    log(f'  all ranks: launches {total}; phase 26: {seconds:.1f} s wall '
        f'({card})')
    return {'launches': total, 'worst': worst, 'ranks': reports,
            'seconds': seconds}


def run_gloo_world(card: str) -> dict:
    """Phase 14: GLOO_WORLD ranks on the one card over gloo, every case
    of GLOO_CASES; fails if any rank fails."""
    log(f'  phase 14: ResNet-32, {GLOO_WORLD} ranks on one card over gloo, '
        f'global batch {GLOO_BATCH}, BatchNorm eval, {len(GLOO_CASES)} mesh '
        f'cases x {GLOO_STEPS} steps')
    stream = _fresh_store('gloo_resnet32.jsonl')
    reports = _run_gloo_ranks('resnet32')
    total = _launch_total(reports)
    for i, (name, *_rest) in enumerate(GLOO_CASES):
        errs = reports[0]['cases'][i]['errors']
        worst = {k: max(e[k] for e in errs)
                 for k in (*STEP_TOL, *METRIC_TOL)}
        clipped = [e['eig_clipped'] for e in errs]
        log(f'  {name} grid {reports[0]["cases"][i]["grid"]}: rank 0 vs '
            f'single-device KFAC, worst of {len(errs)} steps: factors '
            f'{worst["factors"]:.2e}, preconditioned grads '
            f'{worst["precond"]:.2e}, nu {worst["nu"]:.2e}; metrics: nu and '
            f'grad norm {worst["metrics_nu"]:.2e}, preconditioned and '
            f'bucket norms {worst["metrics_norms"]:.2e}, counters equal, '
            f'eig_clipped (world, single) {clipped}')
        for rep in reports:
            case = rep['cases'][i]
            log(f'    rank {rep["rank"]} (row {case["row"]}, col '
                f'{case["col"]}): launches '
                f'{ {k: v for k, v in case["launches"].items() if v} } = '
                f'assignment; step ms (gloo through host memory, '
                f'{GLOO_WORLD} ranks on one card) '
                f'{[round(t, 1) for t in case["step_ms"]]}')
    from distributed_kfac_pytorch_tpu_torch.observability import sink as \
        obs_sink
    records = obs_sink.read_jsonl(str(stream))
    metas = [r['meta'] for r in records if r['kind'] == 'meta']
    steps = [r for r in records if r['kind'] == 'step']
    if metas != [{'rank': 0}] or len(steps) != len(GLOO_CASES) * GLOO_STEPS:
        raise AssertionError(f'phase 14 stream: meta {metas}, '
                             f'{len(steps)} step records')
    log(f'  the metrics stream: rank 0 alone wrote it, {len(steps)} step '
        'records')
    log(f'  all ranks: launches {total} ({card})')
    return {'launches': total, 'ranks': reports}


# ---------------------------------------------------------------------------
# Phases 15-18: the Transformer LM (--arch transformer)
# ---------------------------------------------------------------------------

def _xl_config(**over) -> dict:
    """The LM CLI at Transformer-XL large width, tied, dropout 0, one
    fixed synthetic batch (60,000 train tokens: the first window of
    epoch 0 at every step; 6,000 validation tokens: one window)."""
    config = {'arch': 'transformer', 'emsize': XL_D, 'nlayers': XL_LAYERS,
              'nheads': XL_HEADS, 'tied': True, 'bptt': XL_BPTT,
              'batch_size': XL_BATCH, 'dropout': 0.0,
              'synthetic_vocab': XL_VOCAB, 'synthetic_size': 60_000,
              'fixed_batch': True, 'epochs': 1, 'max_steps': XL_STEPS,
              'seed': 0, 'time_steps': True, 'quiet': True}
    config.update(over)
    return config


def _release() -> None:
    """Free the card between the full-width phases (the capture's hooks
    and the model reference each other)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _run_tlm(label: str, config: dict, per_step: dict, firings: int,
             per_firing: dict | None = None):
    """``train_language_model.train`` on the card with the launch counts
    reset just before and read just after; fails unless every loss is
    finite, ``firings`` steps fired and the launches are ``per_step``
    times the steps plus ``per_firing`` times the firings. Returns
    ``(res, launches, state)``."""
    import torch
    from distributed_kfac_pytorch_tpu_torch import train_language_model
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = train_language_model.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    state = res.pop('state')
    losses, n = res['losses'], res['steps']
    log(f'  losses: {[round(v, 4) for v in losses]}')
    if n != config['max_steps'] or not all(math.isfinite(v)
                                           for v in losses):
        raise AssertionError(f'{label}: {n} steps, losses {losses}')
    if sum(1 for f in res['fired'] if f and f.startswith('inverse')) \
            != firings:
        raise AssertionError(f'{label}: fired {res["fired"]}')
    expected = {k: v * n for k, v in per_step.items()}
    for k, v in (per_firing or {}).items():
        expected[k] += v * firings
    if launches != expected:
        raise AssertionError(f'{label}: launches {launches}, expected '
                             f'{expected}')
    res['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res, launches, state


def _xl_first_window():
    """The fixed batch of the XL phases: epoch 0's first BPTT window."""
    from distributed_kfac_pytorch_tpu_torch.training import datasets
    cfg = _xl_config()
    train_ids, _, _ = datasets.get_lm_corpus(
        synthetic_size=cfg['synthetic_size'], vocab_size=XL_VOCAB)
    return next(datasets.bptt_batches(train_ids, XL_BATCH, XL_BPTT,
                                      shuffle_offset=True, seed=0, epoch=0))


def run_transformer_xl(card: str) -> dict:
    """Phase 15: 12 steps of the Transformer-XL LM (expand, tied, 'auto':
    damped Cholesky on every side), firings at steps 0 and 10."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import factors as F
    res, launches, state = _run_tlm('transformer-xl', _xl_config(),
                                    XL_PER_STEP, 2)
    losses = res['losses']
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'transformer-xl: loss did not decrease: first '
                             f'three {first:.4f}, last three {last:.4f}')
    # The embedding's diagonal A after 12 factor steps on the fixed batch:
    # alpha^12 * 1 + (1 - alpha^12) * (the batch's id frequencies).
    kst = state.kfac_state
    alpha = state.kfac.factor_decay ** XL_STEPS
    freq = F.embedding_a_factor(torch.as_tensor(
        _xl_first_window()[0], device='cuda').long(), XL_VOCAB)
    a_err = _max_rel([(kst['factors']['embed']['A'],
                       alpha + (1 - alpha) * freq)])
    if not a_err <= 1e-5:
        raise AssertionError(f'transformer-xl: embedding A {a_err:.2e} off '
                             'the id frequencies')
    nbytes = {k: sum(t.numel() * 4 for e in kst[k].values()
                     for t in e.values())
              for k in ('factors', 'inverses')}
    params = sum(p.numel() for p in state.model.parameters())
    firing, plain = _step_ms(res)
    summary = {'steps': res['steps'], 'losses': losses,
               'loss_first3': first, 'loss_last3': last,
               'launches': launches, 'firing_ms': firing,
               'step0_ms': res['step_ms'][0],
               'nonfiring_ms': plain,
               'nonfiring_ms_median': statistics.median(plain),
               'params': params, 'factor_bytes': nbytes['factors'],
               'inverse_bytes': nbytes['inverses'],
               'peak_gib': res['peak_gib'], 'embed_a_rel_err': a_err,
               'val': res['val']}
    log(f'  loss first three {first:.4f} -> last three {last:.4f}; '
        f'launches {launches}; embedding A vs frequencies {a_err:.1e}')
    log(f'  {params / 1e6:.1f} M parameters, factors '
        f'{nbytes["factors"] / 1e9:.2f} GB, inverses '
        f'{nbytes["inverses"] / 1e9:.2f} GB, peak allocated '
        f'{res["peak_gib"]:.1f} GiB')
    log(f'  ms/step: non-firing {summary["nonfiring_ms_median"]:.2f} '
        f'(median of {len(plain)}), firing {[round(t, 1) for t in firing]} '
        f'(step 0: {res["step_ms"][0]:.1f}) ({card})')
    del state
    _release()
    return summary


def run_transformer_xl_reduce(card: str) -> dict:
    """Phase 16: the XL model under --kfac-approx reduce (tied statistics
    on), 3 steps; then one capture of the fixed batch: the tied
    embedding's contribution (lookup plus attend site) against the
    lookup's alone, as an expand run takes it."""
    import torch
    res, launches, state = _run_tlm(
        'transformer-xl reduce', _xl_config(max_steps=XL_REDUCE_STEPS,
                                            kfac_approx='reduce'),
        XL_REDUCE_PER_STEP, 1)
    kfac = state.kfac
    summary_map = kfac.approx_summary()
    if summary_map.pop('embed') != 'expand+tied' or set(
            summary_map.values()) != {'reduce'}:
        raise AssertionError(f'reduce: resolved {kfac.approx_summary()}')
    x, y = (torch.as_tensor(t, device='cuda').long()
            for t in _xl_first_window())
    from distributed_kfac_pytorch_tpu_torch.training import engine
    _, _, _, caps = kfac.capture.loss_and_grads(
        lambda out: engine.lm_loss(out, y), x)
    entry, spec = caps['embed'], kfac.specs['embed']
    if 'g_tied' not in entry:
        raise AssertionError('reduce: no tied attend capture')
    tied = kfac.stock_contribs(spec, entry)
    lookup = kfac.stock_contribs(spec, {'a': entry['a'], 'g': entry['g']})
    absent = torch.bincount(x.reshape(-1), minlength=XL_VOCAB) == 0
    d_a = tied['A'] - lookup['A']
    if not (bool((d_a >= 0).all()) and bool((d_a[absent] > 0).all())):
        raise AssertionError('reduce: the embedding A does not hold the '
                             'attend diagonal')
    d_g = float((tied['G'] - lookup['G']).abs().max())
    if not d_g > 0:
        raise AssertionError('reduce: the embedding G lacks the attend '
                             'term')
    firing, plain = _step_ms(res)
    summary = {'losses': res['losses'], 'launches': launches,
               'step_ms': res['step_ms'], 'nonfiring_ms': plain,
               'peak_gib': res['peak_gib'],
               'embed_a_attend_max': float(d_a.max()),
               'embed_a_attend_min_absent': float(d_a[absent].min()),
               'ids_absent': int(absent.sum()),
               'embed_g_attend_max': d_g}
    log(f'  launches {launches}; the tied A exceeds the lookup\'s on all '
        f'{int(absent.sum())} absent ids (min {float(d_a[absent].min()):.2e}'
        f', max over all {float(d_a.max()):.2e}), G by up to {d_g:.3e}')
    log(f'  ms/step: {[round(t, 1) for t in res["step_ms"]]} (step 0 '
        f'fires) ({card})')
    del state, kfac, caps, entry
    _release()
    return summary


def run_transformer_xl_newton(card: str) -> tuple[dict, dict]:
    """Phase 17: the XL model under --inverse-method newton, 3 steps, one
    firing (K4 on the four size buckets); then every size bucket of the
    final factors through K4 beside its plain version (one matrix per
    bucket from XL_NS_PLAIN_ONE_FROM up) and the library Cholesky
    inverse. Returns the summary and the per-firing K4 aggregate."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    res, launches, state = _run_tlm(
        'transformer-xl newton', _xl_config(max_steps=XL_NEWTON_STEPS,
                                            inverse_method='newton'),
        XL_PER_STEP, 1, {'ns_inverse': len(XL_NS_SIZES)})
    damping, iters = state.kfac.damping, state.kfac.newton_iters
    by_size: dict[int, list] = {}
    for f in state.kfac_state['factors'].values():
        for t in f.values():
            if t.ndim == 2:
                by_size.setdefault(t.shape[-1], []).append(t)
    del state
    _release()
    if sorted(by_size) != sorted(XL_NS_SIZES):
        raise AssertionError(f'newton: factor sizes {sorted(by_size)}')
    agg = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0, 't_bytes': 0.0,
           't_ops': 0.0, 'fp32_bound_ms': 0.0, 'max_abs_err': 0.0}
    buckets = []
    for n in XL_NS_SIZES:
        stack = torch.stack(by_size.pop(n))
        count = stack.shape[0]
        inv, k = kernels.batched_inverse(stack, damping, iters,
                                         with_iters=True)
        k = k.tolist()
        sub = 1 if n >= XL_NS_PLAIN_ONE_FROM else count
        inv_p, k_p = kernels.batched_inverse_plain(stack[:sub], damping,
                                                   iters)
        # Every matrix of the bucket is held to the residual bound taken
        # from the plain version, a few matrices at a time (float64).
        res_got = max(_ns_residual(stack[i:i + 8], damping, inv[i:i + 8])
                      for i in range(0, count, 8))
        res_ref = _ns_residual(stack[:sub], damping, inv_p)
        if not torch.isfinite(inv).all() or not res_got <= 2 * max(
                res_ref, 1e-5):
            raise AssertionError(f'newton: bucket ({count},{n},{n}): '
                                 f'residual {res_got:.3g} over all '
                                 f'{count} vs plain {res_ref:.3g}')
        row = {'n': n, 'count': count, 'iters': k,
               'plain_matrices': sub, 'plain_iters': k_p.tolist(),
               'residual': res_got, 'plain_residual': res_ref,
               'max_abs_err': float((inv[:sub] - inv_p).abs().max())}
        row['ms'] = time_ms(lambda: kernels.batched_inverse(
            stack, damping, iters), 1, 3, 1)
        row['plain_ms'] = time_ms(lambda: kernels.batched_inverse_plain(
            stack[:sub], damping, iters), 1, 2, 0)
        eye = torch.eye(n, device='cuda')
        row['library_ms'] = time_ms(lambda: torch.cholesky_inverse(
            torch.linalg.cholesky(stack + damping * eye)), 1, 3, 1)
        ((row['bound_ms'], row['bound_by']),
         (row['fp32_bound_ms'], _)) = ns_bounds(n, count, k)
        for key in ('ms', 'plain_ms', 'library_ms', 'fp32_bound_ms'):
            agg[key] += row[key]
        agg['t_bytes'] += 8.0 * count * n * n / PEAK_BYTES * 1e3
        agg['t_ops'] += 3 * 4.0 * n ** 3 * sum(k) / PEAK_TF32_FLOPS * 1e3
        agg['max_abs_err'] = max(agg['max_abs_err'], row['max_abs_err'])
        buckets.append(row)
        log(f'    bucket ({count},{n},{n}): iterations {sorted(set(k))} '
            f'(plain, {sub} matrices: {sorted(set(row["plain_iters"]))}), '
            f'max|MX-I| {res_got:.2e} over all {count} (plain '
            f'{res_ref:.2e}); ms '
            f'{row["ms"]:.2f}, plain ({sub} matrices) {row["plain_ms"]:.2f}'
            f', lib {row["library_ms"]:.2f}, bound {row["bound_ms"]:.2f} '
            f'({row["bound_by"]})')
        del stack, inv, inv_p
    log(f'  K4 per XL firing: {agg["ms"]:.1f} ms over {len(buckets)} '
        f'buckets; bound {max(agg["t_bytes"], agg["t_ops"]):.1f} ms; '
        f'library {agg["library_ms"]:.1f} ms ({card})')
    summary = {'losses': res['losses'], 'launches': launches,
               'step_ms': res['step_ms'], 'peak_gib': res['peak_gib'],
               'final_factor_buckets': buckets}
    step_ms = [round(t, 1) for t in res['step_ms']]
    log(f'  launches {launches}; ms/step {step_ms} (step 0 fires) ({card})')
    _release()
    return summary, agg


def run_transformer_defaults(card: str) -> dict:
    """Phase 18: the Transformer CLI's own defaults (650 wide, 2 blocks,
    10 heads, untied, dropout 0.5, BPTT 35, batch 20, nothing skipped) on
    the synthetic 10,000 vocabulary, 3 steps."""
    res, launches, state = _run_tlm(
        'transformer defaults', {'arch': 'transformer',
                                 'synthetic_vocab': 10000,
                                 'fixed_batch': True, 'epochs': 1,
                                 'max_steps': TLM_DEFAULT_STEPS, 'seed': 0,
                                 'time_steps': True, 'quiet': True},
        TLM_DEFAULT_PER_STEP, 1)
    specs = state.kfac.specs
    if specs['embed'].kind != 'embedding' or 'decoder' not in specs:
        raise AssertionError(f'transformer defaults: registered '
                             f'{list(specs)}')
    dims = tuple(state.kfac_state['factors']['decoder']['G'].shape)
    summary = {'losses': res['losses'], 'launches': launches,
               'step_ms': res['step_ms'], 'decoder_G': dims}
    log(f'  launches {launches}; decoder G {dims}; ms/step '
        f'{[round(t, 1) for t in res["step_ms"]]} (step 0 fires) ({card})')
    del state
    _release()
    return summary


# ---------------------------------------------------------------------------
# Phases 19-20: the language model over DistributedKFAC
# ---------------------------------------------------------------------------

def _xl_model(layers: int, dev, seq_group=None):
    """The XL-width tied Transformer at ``layers`` blocks, dropout 0,
    built on ``dev`` from seed 0 (attention a ring over ``seq_group`` when
    given)."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.models import transformer_lm
    with torch.random.fork_rng(devices=[dev]), dev:
        torch.manual_seed(0)
        return transformer_lm.TransformerLM(
            XL_VOCAB, d_model=XL_D, num_layers=layers, num_heads=XL_HEADS,
            max_len=XL_BPTT, dropout=0.0, tie_weights=True,
            seq_group=seq_group)


def _step_errors(dk, dk_state, p_dk, kfac, ref_state, p_ref) -> dict:
    """One step's errors of ``DistributedKFAC`` against the single-device
    ``KFAC`` (relative to the largest reference entry): every factor (an
    embedding's diagonal A too), the embeddings' diagonal inverses, every
    preconditioned gradient (the embedding's also on its own) and the
    KL-clip scale."""
    diag = dk.assignment.diag_layers
    precond = _per_tensor_rel(p_dk, p_ref)
    worst = max(precond, key=precond.get)
    return {
        'factors': _max_rel((dk_state['factors'][n][s],
                             ref_state['factors'][n][s])
                            for n in kfac.specs for s in 'AG'),
        'diag_inv': _max_rel((dk_state['diag_inv'][n],
                              ref_state['inverses'][n]['A_inv'])
                             for n in diag),
        'precond': precond[worst], 'precond_worst': worst,
        'embed_precond': max(precond[f'{n}.weight'] for n in diag),
        'nu': _max_rel([(dk.last_nu, kfac.last_nu)])}


def _per_tensor_rel(got: dict, want: dict) -> dict:
    """``{name: max|got - want| / max|want|}`` over ``want``'s tensors."""
    return {n: _max_rel([(got[n].double(), w.double())])
            for n, w in want.items()}


def _fp64_grads(model64, model, x, y) -> dict:
    """The full-batch gradient of ``model``'s parameters taken by
    ``model64``, its fp64 twin (whose attention softmax stays fp32, as the
    model defines it)."""
    from distributed_kfac_pytorch_tpu_torch.training import engine
    model64.load_state_dict(model.state_dict())
    model64.zero_grad(set_to_none=True)
    engine.lm_loss(model64(x), y).backward()
    return {n: p.grad for n, p in model64.named_parameters()}


def _unit(kfac, name: str) -> str:
    """The unit a parameter is preconditioned in: its registered layer
    (whose ``[W | b]`` matrix K-FAC preconditions as one), else itself."""
    layer = name.rsplit('.', 1)[0]
    return layer if layer in kfac.specs else name


def _as_units(kfac, tensors: dict) -> dict:
    """``tensors`` (by parameter) as ``{unit: matrix or tensor}``."""
    from distributed_kfac_pytorch_tpu_torch import layers as L
    out = {n: t for n, t in tensors.items() if _unit(kfac, n) == n}
    for name, spec in kfac.specs.items():
        out[name] = L.grads_to_matrix(spec, kfac._layer_params(name,
                                                               tensors))
    return out


def _fp64_precond(kfac, factors: dict, nu: float, grads: dict) -> dict:
    """A K-FAC step's preconditioned gradients recomputed in fp64 from its
    ``factors`` and KL-clip scale ``nu``, by unit (:func:`_as_units`):
    ``grads`` (fp64) through the damped inverses (Cholesky in fp64; an
    embedding's diagonal A elementwise), unregistered gradients as they
    are. Valid for baked inverses (``'cholesky'``, ``'newton'``), which
    approximate the same operator."""
    import torch
    lam = kfac.damping

    def inverse(m):
        m = m.double()
        return torch.cholesky_inverse(torch.linalg.cholesky(
            m + lam * torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)))

    out = _as_units(kfac, grads)
    for name in kfac.specs:
        f, g = factors[name], out[name]
        if f['A'].ndim == 1:
            v = (1.0 / (f['A'].double() + lam))[:, None] * g @ inverse(f['G'])
        else:
            v = inverse(f['G']) @ g @ inverse(f['A'])
        out[name] = nu * v
    return out


# The tolerance each error of _step_errors is held to.
STEP_ERROR_TOL = {'factors': STEP_TOL['factors'],
                  'diag_inv': STEP_TOL['factors'],
                  'precond': STEP_TOL['precond'],
                  'embed_precond': STEP_TOL['precond'],
                  'nu': STEP_TOL['nu']}


def _held_step(dk, state, precond, ref, ref_state, p_ref, fired, twin, x,
               y, fp64: dict) -> tuple[dict, dict]:
    """Rank 0's errors of one distributed step against the single-device
    ``KFAC`` on the full batch (:func:`_step_errors`) and those over
    STEP_ERROR_TOL. Two fp32 paths can part by more than the gradient
    limit on a small block of a layer's matrix (a bias column): each unit
    with such a tensor is held instead to the fp64 recomputation of its
    own step (the factors of its last firing, ``fired``; the full batch's
    fp64 gradient from ``twin``'s fp64 copy, kept in ``fp64``), relative
    to the unit's largest entry."""
    err = _step_errors(dk, state, precond, ref, ref_state, p_ref)
    over = [n for n, e in _per_tensor_rel(precond, p_ref).items()
            if e > STEP_TOL['precond']]
    if over:
        if 'model' not in fp64:
            fp64['model'] = _xl_model(LM_GLOO_LAYERS, x.device).double()
        g64 = _fp64_grads(fp64['model'], twin, x, y)
        exact_dk = _fp64_precond(ref, fired[0], float(dk.last_nu), g64)
        exact_ref = _fp64_precond(ref, fired[1], float(ref.last_nu), g64)
        mine, theirs = (_as_units(ref, p) for p in (precond, p_ref))
        err['fp64'] = {u: {
            'distributed': _max_rel([(mine[u].double(), exact_dk[u])]),
            'single_device': _max_rel([(theirs[u].double(), exact_ref[u])]),
            'factor_spread': _max_rel([(exact_dk[u], exact_ref[u])])}
            for u in {_unit(ref, n) for n in over}}
    bad = {k: err[k] for k in STEP_ERROR_TOL
           if not err[k] <= STEP_ERROR_TOL[k]}
    if over and all(e['distributed'] <= STEP_TOL['precond']
                    for e in err['fp64'].values()):
        bad.pop('precond', None)
        bad.pop('embed_precond', None)
    return err, bad


def run_transformer_xl_nccl(card: str, xl: dict) -> dict:
    """Phase 19: phase 15's run through ``train_language_model.train``
    inside a one-rank NCCL group (``--comm-method comm-opt``): the same
    losses bit for bit (the XL path runs no cuDNN, and the world-1 step of
    ``DistributedKFAC`` is the single-device step's), the same launches,
    step times beside phase 15's; then the shared-input check
    (:func:`_xl_shared_inputs`) in the same group."""
    import torch.distributed as dist
    from distributed_kfac_pytorch_tpu_torch import launch
    t0 = time.perf_counter()
    store = _fresh_store('nccl_xl_world1.store')
    launch.initialize_distributed(init_method=f'file://{store}', rank=0,
                                  world_size=1, device='cuda')
    try:
        if dist.get_backend() != 'nccl':
            raise AssertionError(f'backend {dist.get_backend()}, not nccl')
        res, launches, state = _run_tlm(
            'transformer-xl NCCL world 1',
            _xl_config(comm_method='comm-opt'), XL_PER_STEP, 2)
        kind = type(state.kfac).__name__
        distributed = state.distributed
        del state
        _release()
        if kind != 'DistributedKFAC' or not distributed:
            raise AssertionError(f'phase 19 ran {kind}, distributed '
                                 f'{distributed}')
        shared = _xl_shared_inputs()
        shift = _nccl_self_shift()
    finally:
        dist.destroy_process_group()
    losses = res['losses']
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, xl['losses'])]
    if losses != xl['losses']:
        raise AssertionError(f'XL NCCL world 1: losses differ from phase '
                             f'15\'s by {[f"{r:.2e}" for r in rel]} '
                             'relative (the path is bitwise reproducible: '
                             'limit 0)')
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'XL NCCL world 1: loss did not decrease: '
                             f'first three {first:.4f}, last three '
                             f'{last:.4f}')
    firing, plain = _step_ms(res)
    summary = {'losses': losses, 'rel_loss_vs_phase15': rel,
               'launches': launches, 'firing_ms': firing,
               'nonfiring_ms': plain,
               'nonfiring_ms_median': statistics.median(plain),
               'peak_gib': res['peak_gib'],
               'phase15_nonfiring_ms_median': xl['nonfiring_ms_median'],
               'phase15_firing_ms': xl['firing_ms'],
               'shared_inputs': shared, 'nccl_self_shift': shift,
               'seconds': time.perf_counter() - t0}
    log(f'  relative to phase 15 per step: {[f"{r:.1e}" for r in rel]}; '
        f'launches {launches}')
    log(f'  ms/step, NCCL world 1: non-firing '
        f'{summary["nonfiring_ms_median"]:.2f} (median), firing '
        f'{[round(t, 2) for t in firing]}; phase 15 (single device): '
        f'{xl["nonfiring_ms_median"]:.2f}, '
        f'{[round(t, 2) for t in xl["firing_ms"]]} ({card})')
    log(f'  phase 19: {summary["seconds"]:.1f} s wall')
    return summary


def _nccl_self_shift() -> dict:
    """The ring shift's NCCL transport inside phase 19's one-rank group:
    rank 0 shifts a phase-22-sized K/V message to itself; the result must
    equal the message and the reverse shift of the backward pass the
    incoming gradient, bit for bit. (A ring of more ranks needs more
    cards: this is the one run of the shift over NCCL.)"""
    import torch
    import torch.distributed as dist
    from distributed_kfac_pytorch_tpu_torch.parallel import sequence
    gen = torch.Generator(device='cuda').manual_seed(19)
    shape = (2, XL_BATCH, XL_BPTT // 4, XL_HEADS, XL_D // XL_HEADS)
    x = torch.randn(shape, generator=gen, device='cuda', requires_grad=True)
    w = torch.randn(shape, generator=gen, device='cuda')
    y = sequence._RingShift.apply(x, dist.group.WORLD, 0, 0)
    (y * w).sum().backward()
    equal = {'forward': torch.equal(y.detach(), x.detach()),
             'backward': torch.equal(x.grad, w)}
    log(f'  the ring shift over NCCL, rank 0 to itself, {list(shape)}: '
        f'forward and backward equal bit for bit {equal}')
    if not all(equal.values()):
        raise AssertionError(f'NCCL self shift: {equal}')
    return {'shape': list(shape), **equal}


def _xl_shared_inputs() -> dict:
    """Phase 19's per-step check, inside its NCCL group: the XL model
    (phase 15's, at XL_SHARED_LAYERS blocks) on the fixed batch, one
    capture per step feeding both the single-device ``KFAC`` and a
    ``DistributedKFAC`` wrapping it (COMM_OPT); under ``expand``
    XL_SHARED_EXPAND_STEPS steps (firings at 0 and 10), then under
    ``reduce`` (tied statistics on) XL_SHARED_REDUCE_STEPS; the model
    stepped with the single-device result (clipped at 0.25, lr 1.0).
    Every step held to STEP_ERROR_TOL; both K-FAC states live on the card
    at once (peak memory printed)."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine
    dev = torch.device('cuda')
    x, y = (torch.as_tensor(t, device=dev).long()
            for t in _xl_first_window())
    model = _xl_model(XL_SHARED_LAYERS, dev)
    out = {'layers': XL_SHARED_LAYERS}
    for approx, steps in (('expand', XL_SHARED_EXPAND_STEPS),
                          ('reduce', XL_SHARED_REDUCE_STEPS)):
        kfac = KFAC(model, damping=0.003, factor_update_freq=1,
                    inv_update_freq=XL_FIRE_EVERY, kl_clip=0.001, lr=1.0,
                    kfac_approx=approx, device=dev)
        dk = DistributedKFAC(kfac, comm_method='comm-opt')
        torch.cuda.reset_peak_memory_stats()
        ref_state, dk_state = kfac.init_state(), dk.init_state()
        errors, failures = [], []
        for step in range(steps):
            inv = step % XL_FIRE_EVERY == 0
            _, _, grads, captures = kfac.capture.loss_and_grads(
                lambda o: engine.lm_loss(o, y), x)
            p_ref, ref_state = kfac.step(ref_state, grads, captures,
                                         factor_update=True, inv_update=inv)
            p_dk, dk_state = dk.step(dk_state, grads, captures,
                                     factor_update=True, inv_update=inv)
            err = _step_errors(dk, dk_state, p_dk, kfac, ref_state, p_ref)
            errors.append(err)
            bad = {k: err[k] for k in STEP_ERROR_TOL
                   if not err[k] <= STEP_ERROR_TOL[k]}
            if bad:
                failures.append(f'{approx} step {step}: {bad} (worst '
                                f'gradient {err["precond_worst"]})')
            del grads, captures, p_dk
            with torch.no_grad():
                update = engine.clip_by_global_norm(p_ref, 0.25)
                for n, p in model.named_parameters():
                    p -= update[n]
            del p_ref, update
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        approx_map = kfac.approx_summary()
        kfac.capture.close()
        del kfac, dk, ref_state, dk_state
        _release()
        worst = {k: max(e[k] for e in errors) for k in STEP_ERROR_TOL}
        log(f'  shared inputs, {approx}, {steps} steps at '
            f'{XL_SHARED_LAYERS} blocks, DistributedKFAC (NCCL, world 1) '
            f'vs single-device KFAC, worst: '
            + ', '.join(f'{k} {v:.2e}' for k, v in worst.items())
            + f'; both states on the card: peak {peak:.1f} GiB')
        if failures:
            raise AssertionError(f'XL NCCL world 1, shared inputs: '
                                 f'{failures}')
        if approx == 'reduce' and approx_map.get('embed') != 'expand+tied':
            raise AssertionError(f'shared inputs: resolved {approx_map}')
        out[approx] = {'steps': steps, 'errors': errors, 'worst': worst,
                       'peak_gib': peak}
    del model
    _release()
    return out


# (name, comm method, grad-worker fraction, expected grid, KFAC knobs)
LM_GLOO_CASES = (  # (name, seq_parallel, comm_method, fraction, grid, knobs)
    ('comm_opt_expand', 1, 'comm-opt', 0.0, (1, 4),
     {'kfac_approx': 'expand'}),
    ('mem_opt_reduce', 1, 'mem-opt', 0.0, (4, 1), {'kfac_approx': 'reduce'}),
    ('hybrid_opt_reduce_newton', 1, 'hybrid-opt', 0.5, (2, 2),
     {'kfac_approx': 'reduce', 'inverse_method': 'newton',
      'symmetry_aware_comm': True}))


def _digest(*dicts) -> str:
    """A hash of every tensor of ``dicts`` (nested one level for factor
    dicts), in key order: equal digests mean equal bits."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for d in dicts:
        for key in sorted(d):
            value = d[key]
            for t in (value.values() if isinstance(value, dict)
                      else (value,)):
                h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _lm_gloo_cases(cases, rank: int) -> tuple[list, list]:
    """Every case ``(name, sp, comm_method, fraction, grid, knobs)`` on
    this rank of a gloo world (phases 20 and 22): the XL-width tied
    Transformer at LM_GLOO_LAYERS blocks, its attention a ring over this
    rank's sequence group when ``sp > 1``, on its tile of the fixed
    global batch (K-FAC rank ``rank // sp`` takes its sequences, sequence
    index ``rank % sp`` its block of positions), LM_GLOO_STEPS steps,
    inverses every LM_GLOO_INV_FREQ-th. Where the step is the
    single-device step on the full batch (``sp == 1`` or ``expand``),
    rank 0 holds it there (:func:`_held_step`); every rank records a
    digest of each step's factors and preconditioned gradients, and its
    launches and grid place are held to its assignment. Returns the
    case reports and the failures."""
    import torch
    import torch.distributed as dist
    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.parallel import sequence
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine

    dev = torch.device('cuda:0')
    x, y = (torch.as_tensor(t, device=dev).long()
            for t in _xl_first_window())
    groups = {sp: sequence.make_sequence_group(sp)
              for sp in sorted({c[1] for c in cases})}
    # Rank 0's reference runs on a twin of the model, loaded with the
    # model's parameters before each of its steps: two captures on one
    # model would nest the tied embedding's wrapped attend call.
    twin = _xl_model(LM_GLOO_LAYERS, dev) if rank == 0 else None
    fp64 = {}       # rank 0's fp64 twin, built at its first use
    knobs = dict(damping=0.003, factor_update_freq=1,
                 inv_update_freq=LM_GLOO_INV_FREQ, kl_clip=0.001, lr=1.0,
                 device=dev)
    out, failures = [], []
    for name, sp, comm, frac, grid, extra in cases:
        rows, cols = launch.process_local_tile(XL_BATCH, XL_BPTT, sp)
        model = _xl_model(LM_GLOO_LAYERS, dev, groups[sp])
        kfac = KFAC(model, **knobs, **extra)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac, seq_parallel=sp)
        work = dk.local_work()
        state = dk.init_state()
        expand = extra['kfac_approx'] == 'expand'
        ref = ref_state = None
        if rank == 0 and (sp == 1 or expand):
            ref = KFAC(twin, **knobs, **extra)
            ref_state = ref.init_state()
        launches = dict.fromkeys(kernels.LAUNCHES, 0)
        errors, step_ms, digests = [], [], []
        firings = 0
        for step in range(LM_GLOO_STEPS):
            inv = step % LM_GLOO_INV_FREQ == 0
            firings += inv
            torch.cuda.synchronize()
            dist.barrier()     # rank 0's reference check runs between steps
            kernels.reset_launches()
            t0 = time.perf_counter()
            _, _, grads, captures = kfac.capture.loss_and_grads(
                lambda o: engine.lm_loss(o, y[rows, cols]), x[rows, cols],
                pos_offset=cols.start)
            grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
            precond, state = dk.step(state, grads, captures,
                                     factor_update=True, inv_update=inv)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
            del grads, captures
            digests.append(_digest(state['factors'], precond))
            if ref is not None:
                twin.load_state_dict(model.state_dict())
                _, _, g_full, c_full = ref.capture.loss_and_grads(
                    lambda o: engine.lm_loss(o, y), x)
                p_ref, ref_state = ref.step(ref_state, g_full, c_full,
                                            factor_update=True,
                                            inv_update=inv)
                if inv:     # the factors the inverses were taken from
                    fired = (state['factors'], ref_state['factors'])
                err, bad = _held_step(dk, state, precond, ref, ref_state,
                                      p_ref, fired, twin, x, y, fp64)
                errors.append(err)
                if bad:
                    failures.append(f'{name} step {step}: {bad} (worst '
                                    f'gradient {err["precond_worst"]}; '
                                    f'fp64 {err.get("fp64")})')
                del g_full, c_full, p_ref
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p -= precond[n]
            del precond
        expected = dict.fromkeys(kernels.LAUNCHES, 0)
        expected.update({
            # Every dense side of this rank's captures, and the untied-
            # statistics embedding's G under expand.
            'factor_ema': (12 * LM_GLOO_LAYERS + expand) * LM_GLOO_STEPS,
            'bucket_precond': len(work['precondition']) * LM_GLOO_STEPS})
        if extra.get('inverse_method') == 'newton':
            expected['ns_inverse'] = len(work['decompose']) * firings
        if launches != expected:
            failures.append(f'{name}: rank {rank} launches {launches}, '
                            f'expected {expected} from the assignment')
        k_rank = rank // sp
        if ((dk.n_rows, dk.n_cols) != grid
                or (dk.row, dk.col) != divmod(k_rank, grid[1])):
            failures.append(f'{name}: rank {rank} at {(dk.row, dk.col)} of '
                            f'grid {(dk.n_rows, dk.n_cols)}')
        out.append({
            'name': name, 'seq_parallel': sp, 'kfac_rank': k_rank,
            'grid': [dk.n_rows, dk.n_cols], 'row': dk.row, 'col': dk.col,
            'tile': [[rows.start, rows.stop], [cols.start, cols.stop]],
            'work': {'decompose': work['decompose'],
                     'precondition': [list(s) for s in work['precondition']]},
            'launches': launches, 'expected': expected, 'digests': digests,
            'errors': errors, 'step_ms': step_ms})
        kfac.capture.close()
        if ref is not None:
            ref.capture.close()
        del model, kfac, dk, state, ref, ref_state
        _release()
    del twin, fp64
    _release()
    return out, failures


def _gloo_cli_case(rank: int, name: str, config: dict, expected_fn,
                   seq_parallel: int = 1) -> tuple[dict, list]:
    """The LM CLI itself on the gloo world: ``config`` through
    ``train_language_model.train`` with the launch counts reset just
    before; fails unless K-FAC ran as ``DistributedKFAC`` (with
    ``seq_parallel`` ranks per sequence group, its attention a ring when
    more than one), every loss is finite and the launches equal
    ``expected_fn(work, firings)`` from the rank's assignment."""
    from distributed_kfac_pytorch_tpu_torch import train_language_model
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    kernels.reset_launches()
    res = train_language_model.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    st = res.pop('state')
    dk = st.kfac
    work = dk.local_work()
    firings = res['fired'].count('inverse')
    expected = dict.fromkeys(kernels.LAUNCHES, 0)
    expected.update(expected_fn(work, firings))
    attn = getattr(st.model, 'block0', None)
    ring = attn is not None and attn.attn.seq_group is not None
    failures = []
    if (type(dk).__name__ != 'DistributedKFAC' or not st.distributed
            or dk.seq_parallel != seq_parallel
            or ring != (seq_parallel > 1)):
        failures.append(f'{name}: not a DistributedKFAC with seq_parallel '
                        f'{seq_parallel}')
    if launches != expected:
        failures.append(f'{name}: rank {rank} launches {launches}, '
                        f'expected {expected} from the assignment')
    if not all(math.isfinite(v) for v in res['losses']):
        failures.append(f'{name}: losses {res["losses"]}')
    case = {'name': name, 'seq_parallel': seq_parallel,
            'kfac_rank': rank // seq_parallel,
            'grid': [dk.n_rows, dk.n_cols], 'row': dk.row, 'col': dk.col,
            'work': {'decompose': work['decompose'],
                     'precondition': [list(s) for s in work['precondition']]},
            'launches': launches, 'expected': expected,
            'losses': res['losses'], 'val': res['val']['loss'],
            'firings': firings, 'digests': [], 'errors': [],
            'step_ms': res['step_ms']}
    st.kfac.capture.close()
    return case, failures


def _gloo_lm_rank(cfg: dict, cases, cli) -> int:
    """One rank of phase 20 or 22 (``chip_smoke.py --dist-worker CONFIG``
    with ``phase`` 'lm' or 'seq'): :func:`_lm_gloo_cases` over ``cases``,
    then ``cli()``, the LM CLI case; writes the rank's report."""
    import torch.distributed as dist
    from distributed_kfac_pytorch_tpu_torch import launch, set_fp32_precision
    set_fp32_precision()
    meta = launch.initialize_distributed(
        init_method=f'file://{cfg["store"]}', backend='gloo',
        device='cuda:0', timeout=600)
    rank = meta['process_index']
    report = {'rank': rank}
    report['cases'], failures = _lm_gloo_cases(cases, rank)
    case, more = cli(rank)
    report['cases'].append(case)
    report['failures'] = failures + more
    Path(cfg['out']).write_text(json.dumps(report, indent=1))
    dist.destroy_process_group()
    return 1 if report['failures'] else 0


def lm_dist_worker(cfg: dict) -> int:
    """A rank of phase 20: LM_GLOO_CASES (one sequence per rank), then the
    LM CLI for the LSTM (PTB medium, HYBRID_OPT 2 x 2, eigen + jacobi)."""
    return _gloo_lm_rank(cfg, LM_GLOO_CASES, lambda rank: _gloo_cli_case(
        rank, 'lstm_cli_hybrid_jacobi', _lm_config(
            max_steps=LM_GLOO_STEPS, inverse_method='eigen',
            eigh_method='jacobi', comm_method='hybrid-opt',
            grad_worker_fraction=0.5),
        lambda work, firings: {
            'bucket_precond': len(work['precondition']) * LM_GLOO_STEPS,
            'jacobi_eigh': len(work['decompose']) * firings}))


def seq_dist_worker(cfg: dict) -> int:
    """A rank of phase 22: SEQ_GLOO_CASES (the ring), then the LM CLI for
    the XL-width Transformer at LM_GLOO_LAYERS blocks with
    ``--seq-parallel SEQ_CLI_SP`` (COMM_OPT over the K-FAC ranks)."""
    return _gloo_lm_rank(cfg, SEQ_GLOO_CASES, lambda rank: _gloo_cli_case(
        rank, f'transformer_cli_seq_parallel_{SEQ_CLI_SP}', _xl_config(
            nlayers=LM_GLOO_LAYERS, max_steps=LM_GLOO_STEPS,
            kfac_update_freq=LM_GLOO_INV_FREQ, seq_parallel=SEQ_CLI_SP,
            comm_method='comm-opt'),
        lambda work, firings: {
            'factor_ema': (12 * LM_GLOO_LAYERS + 1) * LM_GLOO_STEPS,
            'bucket_precond': len(work['precondition']) * LM_GLOO_STEPS},
        seq_parallel=SEQ_CLI_SP))


def _run_lm_gloo(phase: str, number: int, card: str) -> dict:
    """Phase 20 (``phase`` 'lm') or 22 ('seq'): GLOO_WORLD ranks on the one
    card over gloo; fails if any rank fails, if the ranks' digests of any
    step differ (every rank ends a step with the same factors and
    preconditioned gradients), or if the ranks' CLI losses differ."""
    t0 = time.perf_counter()
    reports = _run_gloo_ranks(phase)
    for i, case in enumerate(reports[0]['cases']):
        digests = [rep['cases'][i]['digests'] for rep in reports]
        if any(d != digests[0] for d in digests):
            raise AssertionError(f'{case["name"]}: the ranks\' factors or '
                                 f'preconditioned gradients differ: '
                                 f'{digests}')
    cli = [rep['cases'][-1] for rep in reports]
    if any(c['losses'] != cli[0]['losses'] or c['val'] != cli[0]['val']
           for c in cli):
        raise AssertionError(f'{cli[0]["name"]}: the ranks\' losses differ: '
                             f'{[c["losses"] for c in cli]}')
    total = _launch_total(reports)
    for i, case in enumerate(reports[0]['cases']):
        errs = case['errors']
        head = (f'  {case["name"]} grid {case["grid"]}, sp '
                f'{case["seq_parallel"]}: ')
        if errs:
            worst = {k: max(e[k] for e in errs) for k in STEP_ERROR_TOL}
            tensor = max(errs, key=lambda e: e['precond'])['precond_worst']
            log(head + f'rank 0 vs single-device KFAC, worst of {len(errs)} '
                'steps: ' + ', '.join(f'{k} {v:.2e}'
                                      for k, v in worst.items())
                + f' ({tensor})')
            for step, e in enumerate(errs):
                for n, v in e.get('fp64', {}).items():
                    log(f'    step {step} {n}: a tensor over '
                        f'{STEP_TOL["precond"]}; the unit vs its fp64 '
                        f'recomputation: distributed '
                        f'{v["distributed"]:.2e}, single-device '
                        f'{v["single_device"]:.2e}; the two fp64 results '
                        f'(their factors) {v["factor_spread"]:.2e} apart')
        if 'losses' in case:
            log(head + f'losses {[round(v, 4) for v in case["losses"]]} '
                f'on every rank, {case["firings"]} firing(s)')
        elif not errs:
            log(head + 'every rank\'s factors and preconditioned gradients '
                'equal bit for bit on each step')
        for rep in reports:
            c = rep['cases'][i]
            log(f'    rank {rep["rank"]} (K-FAC rank {c["kfac_rank"]}, row '
                f'{c["row"]}, col {c["col"]}): launches '
                f'{ {k: v for k, v in c["launches"].items() if v} } = '
                f'assignment; step ms (gloo through host memory, '
                f'{GLOO_WORLD} ranks on one card) '
                f'{[round(t, 1) for t in c["step_ms"]]}')
    seconds = time.perf_counter() - t0
    log(f'  all ranks: launches {total}; phase {number}: {seconds:.1f} s '
        f'wall ({card})')
    return {'launches': total, 'ranks': reports, 'seconds': seconds}


def run_lm_gloo_world(card: str) -> dict:
    """Phase 20: LM_GLOO_CASES and the LSTM CLI on 4 gloo ranks."""
    log(f'  phase 20, distributed: the LM at XL width, {LM_GLOO_LAYERS} '
        f'blocks, global batch {XL_BATCH}, {len(LM_GLOO_CASES)} mesh cases x '
        f'{LM_GLOO_STEPS} steps; the LSTM CLI, hybrid-opt 2 x 2, jacobi')
    return _run_lm_gloo('lm', 20, card)


# ---------------------------------------------------------------------------
# Phases 21-22: the chunked attention fold and the ring
# ---------------------------------------------------------------------------

def _attention_run(fn, q, k, v, w) -> dict:
    """``fn(q, k, v)`` and the gradients of ``sum(fn * w)``, twice (the
    second timed with the host clock after ``synchronize``); the peak
    memory of a run above what was allocated before it."""
    import torch
    for _ in range(2):
        _release()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*leaves)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return {'out': out.detach(), 'grads': [t.grad for t in leaves],
            'ms': ms, 'peak_gib': peak}


def check_chunked_attention(card: str) -> dict:
    """Phase 21, first part: ``chunked_causal_attention`` at ATTN_SHAPE,
    block ATTN_BLOCK, against ``local_causal_attention`` on the same
    inputs: the output (<= 1e-5) and the q/k/v gradients (<= 1e-4),
    relative to the largest plain entry; forward + backward ms and peak
    memory of each."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.parallel import sequence
    gen = torch.Generator(device='cuda').manual_seed(21)
    q, k, v, w = (torch.randn(ATTN_SHAPE, generator=gen, device='cuda')
                  for _ in range(4))
    local = _attention_run(sequence.local_causal_attention, q, k, v, w)
    chunked = _attention_run(
        lambda q, k, v: sequence.chunked_causal_attention(
            q, k, v, block_size=ATTN_BLOCK), q, k, v, w)
    errs = {'out': _max_rel([(chunked['out'], local['out'])])}
    errs.update({f'grad_{n}': _max_rel([(a, b)]) for n, a, b in zip(
        'qkv', chunked['grads'], local['grads'])})
    summary = {'shape': list(ATTN_SHAPE), 'block': ATTN_BLOCK,
               'rel_err': errs,
               'ms': {'local': local['ms'], 'chunked': chunked['ms']},
               'peak_gib': {'local': local['peak_gib'],
                            'chunked': chunked['peak_gib']}}
    log(f'  attention {ATTN_SHAPE}, block {ATTN_BLOCK}: chunked vs local '
        + ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
        + f'; forward + backward {chunked["ms"]:.1f} ms, peak '
        f'{chunked["peak_gib"]:.2f} GiB (local {local["ms"]:.1f} ms, '
        f'{local["peak_gib"]:.2f} GiB) ({card})')
    bad = {n: e for n, e in errs.items()
           if not e <= (CHUNKED_OUT_TOL if n == 'out' else CHUNKED_GRAD_TOL)}
    del local, chunked, q, k, v, w
    _release()
    if bad:
        raise AssertionError(f'chunked attention vs local: {bad}')
    return summary


def run_transformer_xl_chunked(card: str, xl: dict) -> dict:
    """Phase 21: the fold alone (:func:`check_chunked_attention`), then
    phase 15's run under ``--attn-block-size XL_ATTN_BLOCK``: every loss
    finite and falling, steps 0-2 within XL_CHUNKED_LOSS_TOL relative of
    phase 15's (the fold reorders the softmax sums), phase 15's launches;
    step times and peak memory beside phase 15's."""
    t0 = time.perf_counter()
    attention = check_chunked_attention(card)
    res, launches, state = _run_tlm(
        'transformer-xl chunked', _xl_config(attn_block_size=XL_ATTN_BLOCK),
        XL_PER_STEP, 2)
    block = state.model.block0.attn.attn_block_size
    del state
    _release()
    if block != XL_ATTN_BLOCK:
        raise AssertionError(f'phase 21 model block size {block}')
    losses = res['losses']
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, xl['losses'])]
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'XL chunked: loss did not decrease: first '
                             f'three {first:.4f}, last three {last:.4f}')
    if not all(r <= XL_CHUNKED_LOSS_TOL for r in rel[:XL_CHUNKED_HELD]):
        raise AssertionError(f'XL chunked: steps 0-{XL_CHUNKED_HELD - 1} '
                             f'differ from phase 15\'s by {rel}')
    if launches != xl['launches']:
        raise AssertionError(f'XL chunked: launches {launches}, phase 15 '
                             f'{xl["launches"]}')
    firing, plain = _step_ms(res)
    summary = {'attention': attention, 'losses': losses,
               'rel_loss_vs_phase15': rel, 'launches': launches,
               'firing_ms': firing, 'nonfiring_ms': plain,
               'nonfiring_ms_median': statistics.median(plain),
               'peak_gib': res['peak_gib'],
               'phase15_nonfiring_ms_median': xl['nonfiring_ms_median'],
               'phase15_firing_ms': xl['firing_ms'],
               'phase15_peak_gib': xl['peak_gib'],
               'seconds': time.perf_counter() - t0}
    log(f'  losses relative to phase 15: {[f"{r:.1e}" for r in rel]}; '
        f'launches {launches} (= phase 15)')
    log(f'  ms/step, block {XL_ATTN_BLOCK}: non-firing '
        f'{summary["nonfiring_ms_median"]:.2f} (median), firing '
        f'{[round(t, 2) for t in firing]}, peak allocated '
        f'{res["peak_gib"]:.2f} GiB; phase 15: '
        f'{xl["nonfiring_ms_median"]:.2f}, '
        f'{[round(t, 2) for t in xl["firing_ms"]]}, '
        f'{xl["peak_gib"]:.2f} GiB ({card})')
    log(f'  phase 21: {summary["seconds"]:.1f} s wall')
    return summary


def run_seq_gloo_world(card: str) -> dict:
    """Phase 22: SEQ_GLOO_CASES (the ring) and the Transformer CLI with
    ``--seq-parallel SEQ_CLI_SP`` on 4 gloo ranks."""
    log(f'  phase 22, sequence parallelism: the LM at XL width, '
        f'{LM_GLOO_LAYERS} blocks, the ring over sequence groups, global '
        f'batch {XL_BATCH} x {XL_BPTT}, {len(SEQ_GLOO_CASES)} cases x '
        f'{LM_GLOO_STEPS} steps; the Transformer CLI, --seq-parallel '
        f'{SEQ_CLI_SP}')
    return _run_lm_gloo('seq', 22, card)


# ---------------------------------------------------------------------------
# Phases 27-28: checkpoint, preemption and verified resume
# ---------------------------------------------------------------------------

# Phase 27: the ImageNet CLI at ResNet-50's published widths, 224 px, batch
# 64, 512 synthetic images (8 steps per epoch), 2 epochs, factors every
# step, inverses every 10, step bundles every 4 steps, an epoch bundle
# every epoch, deterministic cuDNN. The pipelined case adds 5 chunks, the
# deferred reduction and --inverse-method newton (K4 fires after the
# resume).
RESUME_R50 = ('--model', 'resnet50', '--image-size', '224', '--batch-size',
              '64', '--synthetic-size', '512', '--epochs', '2',
              '--kfac-cov-update-freq', '1', '--kfac-update-freq', '10',
              '--checkpoint-steps', '4', '--checkpoint-freq', '1',
              '--deterministic')
RESUME_PIPELINED = ('--inv-pipeline-chunks', '5',
                    '--deferred-factor-reduction', '--inverse-method',
                    'newton')
# Subprocesses of phase 27 on the card at once (each ResNet-50 run holds
# about 15 GB), and each run's time limit.
RESUME_CONCURRENCY, RESUME_TIMEOUT = 3, 600
# Phase 28: the CIFAR CLI at ResNet-32's full width on GLOO_WORLD gloo
# ranks of cuda:0, HYBRID_OPT 2 x 2, batch 128, 1024 synthetic images (8
# steps per epoch), 2 epochs, 2 chunks and the deferred reduction,
# inverses every 4, step bundles every 3, the Jacobi eigh (K5).
RESUME_R32 = ('--model', 'resnet32', '--batch-size', '128',
              '--synthetic-size', '1024', '--epochs', '2',
              '--kfac-update-freq', '4', '--comm-method', 'hybrid-opt',
              '--grad-worker-fraction', '0.5', '--inv-pipeline-chunks', '2',
              '--deferred-factor-reduction', '--eigh-method', 'jacobi',
              '--checkpoint-steps', '3', '--checkpoint-freq', '1',
              '--dist-backend', 'gloo', '--deterministic')
RESUME_WORLD_TIMEOUT = 300


def _resume_env(chaos: str | None = None, **extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != 'KFAC_CHAOS'}
    env.update(PYTHONUNBUFFERED='1', **extra)
    if chaos:
        env['KFAC_CHAOS'] = chaos
    return env


def _cli_argv(module: str, flags, directory: Path) -> list:
    return [sys.executable, '-m', f'distributed_kfac_pytorch_tpu_torch.{module}',
            *flags, '--checkpoint-dir', str(directory),
            '--launch-counts', str(directory) + '.launches.{rank}.json']


def _launches_of(directory: Path, ranks: int = 1) -> dict:
    """The launch counts the runs into ``directory`` wrote (summed over
    ``ranks`` and over the runs read so far: each file is read once)."""
    total = {}
    for r in range(ranks):
        path = Path(f'{directory}.launches.{r}.json')
        if path.exists():
            for k, v in json.loads(path.read_text()).items():
                total[k] = total.get(k, 0) + v
            path.unlink()
    return total


def _add(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def _bundle_diff(a, b, path='') -> tuple[int, float, list]:
    """``(leaves that differ, largest |a - b| over float tensors, the
    first differing paths)`` of two bundle trees."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.resilience import integrity
    if isinstance(a, dict):
        if set(a) != set(b):
            return 1, math.inf, [f'{path} keys']
        n, worst, where = 0, 0.0, []
        for k in a:
            if k == integrity.CHECKSUM_KEY:
                continue
            dn, dw, dp = _bundle_diff(a[k], b[k], f'{path}/{k}')
            n, worst, where = n + dn, max(worst, dw), where + dp
        return n, worst, where[:5]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return 1, math.inf, [path]
        out = [_bundle_diff(x, y, f'{path}[{i}]')
               for i, (x, y) in enumerate(zip(a, b))]
        return (sum(o[0] for o in out), max([o[1] for o in out] or [0.0]),
                [p for o in out for p in o[2]][:5])
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape:
            return 1, math.inf, [path]
        if torch.equal(a, b):
            return 0, 0.0, []
        worst = (float((a.double() - b.double()).abs().max())
                 if a.is_floating_point() else math.inf)
        return 1, worst, [path]
    return (0, 0.0, []) if a == b else (1, math.inf, [path])


def _load_bundle_files(directory: Path) -> dict:
    """Every file of a bundle directory, on the host: ``{name: tree}``."""
    import torch
    return {p.name: torch.load(p, map_location='cpu', weights_only=True)
            for p in sorted(directory.glob('*.pt'))}


def _held_to(label: str, got: Path, want: Path) -> dict:
    """Hold bundle directory ``got`` to ``want`` file by file: equal bit
    for bit (``--deterministic`` makes two uninterrupted runs on the card
    equal; ``--determinism-probe`` shows they differ without it), or
    raise."""
    a, b = _load_bundle_files(got), _load_bundle_files(want)
    n, worst, where = _bundle_diff(a, b)
    log(f'  {label}: {sorted(a)} vs the uninterrupted run: '
        + ('equal bit for bit' if n == 0 else
           f'{n} leaves differ, largest |diff| {worst:.3e} at {where}'))
    if n:
        raise AssertionError(f'{label}: resumed bundle differs from the '
                             f'uninterrupted run: {n} leaves, {where}')
    return {'differing_leaves': n, 'max_abs_diff': worst}


def _resumed_line(out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith('resumed from')]
    if len(lines) != 1:
        raise AssertionError(f'expected one resume line, got {lines}:\n'
                             f'{out[-3000:]}')
    return lines[0]


def run_resume_resnet50(card: str) -> dict:
    """Phase 27: ResNet-50 preempted, killed and resumed through the
    ImageNet CLI's module entry point (each run a subprocess), every
    resumed final bundle held to its uninterrupted run's; then the
    bundle's bytes and its save, restore and checksum ms."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    log(f'  phase 27: ResNet-50 at 224 px, batch 64, 2 epochs of 8 steps '
        f'through the ImageNet CLI (subprocesses, {RESUME_CONCURRENCY} at '
        'a time): uninterrupted, preempt@5, crash@9, and preempt@5 with 5 '
        'chunks, the deferred reduction and newton')
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix='kfac-resume-'))
    sem = threading.BoundedSemaphore(RESUME_CONCURRENCY)
    launches: dict = {}
    lock = threading.Lock()

    walls: list = []

    def run(name: str, flags=(), chaos=None) -> tuple[int, str]:
        d = tmp / name
        with sem:
            t = time.perf_counter()
            p = subprocess.run(
                _cli_argv('train_imagenet_resnet', [*RESUME_R50, *flags], d),
                cwd=ROOT, env=_resume_env(chaos), capture_output=True,
                text=True, timeout=RESUME_TIMEOUT)
            t = time.perf_counter() - t
        saves = [float(ln.split(' saved in ')[1].split()[0])
                 for ln in p.stdout.splitlines()
                 if ln.startswith('checkpoint: step ')]
        with lock:
            _add(launches, _launches_of(d))
            walls.append((name + (f' {chaos}' if chaos else ''), t, saves))
        return p.returncode, p.stdout + p.stderr

    def keep_final(name: str) -> None:
        """Only the final epoch bundle is compared: drop the rest."""
        d = tmp / name
        shutil.rmtree(d / 'steps', ignore_errors=True)
        shutil.rmtree(d / '0', ignore_errors=True)

    def uninterrupted(name: str, flags=()) -> dict:
        rc, out = run(name, flags)
        if rc != 0:
            raise AssertionError(f'{name}: exit {rc}\n{out[-4000:]}')
        keep_final(name)
        return {'exit': rc}

    def interrupted(name: str, flags, chaos: str, rc_want: int,
                    labels_want: list, resume_want: str) -> dict:
        rc, out = run(name, flags, chaos)
        if rc != rc_want:
            raise AssertionError(f'{name}: exit {rc}, expected {rc_want}\n'
                                 f'{out[-4000:]}')
        labels = sorted(int(n) for n in os.listdir(tmp / name / 'steps')
                        if n.isdigit())
        if labels != labels_want:
            raise AssertionError(f'{name}: step bundles {labels}, expected '
                                 f'{labels_want}')
        rc2, out2 = run(name, flags)
        if rc2 != 0:
            raise AssertionError(f'{name} relaunch: exit {rc2}\n'
                                 f'{out2[-4000:]}')
        line = _resumed_line(out2)
        if resume_want not in line:
            raise AssertionError(f'{name}: {line!r}, expected '
                                 f'{resume_want!r}')
        keep_final(name)
        saves = [ln for ln in (out + out2).splitlines()
                 if ln.startswith('checkpoint:')]
        return {'exit': rc, 'step_bundles': labels, 'resumed': line,
                'saves': saves}

    jobs = {
        'uninterrupted': lambda: uninterrupted('ref'),
        'uninterrupted_pipelined': lambda: uninterrupted(
            'ref_pipe', RESUME_PIPELINED),
        'preempt@5': lambda: interrupted(
            'preempt', (), 'preempt@5', 75, [4, 5],
            'step checkpoint 5 (epoch 0, mid-epoch offset 5, global step 5)'),
        'crash@9': lambda: interrupted(
            'crash', (), 'crash@9', 137, [4, 8], 'global step 8)'),
        'preempt@5 pipelined': lambda: interrupted(
            'preempt_pipe', RESUME_PIPELINED, 'preempt@5', 75, [4, 5],
            'step checkpoint 5 (epoch 0, mid-epoch offset 5, global step 5)'),
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        runs = {k: f.result() for k, f in futures.items()}
    for k in ('preempt@5', 'crash@9', 'preempt@5 pipelined'):
        log(f'  {k}: exit {runs[k]["exit"]}, step bundles '
            f'{runs[k]["step_bundles"]}; relaunch {runs[k]["resumed"]}')
    held = {k: _held_to(k, tmp / name / '1', tmp / ref / '1')
            for k, name, ref in (('preempt@5', 'preempt', 'ref'),
                                 ('crash@9', 'crash', 'ref'),
                                 ('preempt@5 pipelined', 'preempt_pipe',
                                  'ref_pipe'))}
    log(f'  each run: wall s, its step saves ms ({RESUME_CONCURRENCY} on '
        'the card at once): '
        + '; '.join(f'{n} {t:.1f} {[round(v) for v in sv]}'
                    for n, t, sv in walls))
    t_fig = time.perf_counter()
    figures = _bundle_figures(tmp / 'ref', card)
    t_fig = time.perf_counter() - t_fig
    seconds = time.perf_counter() - t0
    log(f'  launches {launches}; phase 27: {seconds:.1f} s wall, the '
        f'bundle figures {t_fig:.1f} of it ({card})')
    shutil.rmtree(tmp, ignore_errors=True)
    return {'runs': runs, 'held': held, 'figures': figures,
            'walls': walls, 'launches': launches, 'seconds': seconds}


def run_determinism_probe(card: str) -> dict:
    """``--determinism-probe``: what ``--deterministic`` buys and costs at
    phase 27's ResNet-50. Two uninterrupted runs of phase 27's CLI without
    the flag (at once), their final bundles compared; then phase 6's 12
    steps timed in this process with cuDNN's deterministic algorithms off,
    on, on and off."""
    import shutil
    import tempfile
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet

    _release()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix='kfac-determinism-'))
    flags = [f for f in RESUME_R50 if f != '--deterministic']

    def run(name: str) -> None:
        p = subprocess.run(
            _cli_argv('train_imagenet_resnet', flags, tmp / name), cwd=ROOT,
            env=_resume_env(), capture_output=True, text=True,
            timeout=RESUME_TIMEOUT)
        if p.returncode != 0:
            raise AssertionError(f'{name}: exit {p.returncode}\n'
                                 f'{(p.stdout + p.stderr)[-4000:]}')

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(run, ['a', 'b']))
    n, worst, where = _bundle_diff(_load_bundle_files(tmp / 'a' / '1'),
                                   _load_bundle_files(tmp / 'b' / '1'))
    shutil.rmtree(tmp, ignore_errors=True)
    log(f'  two uninterrupted phase-27 runs without --deterministic: {n} '
        f'leaves differ, largest |diff| {worst:.3e}, first at {where}')
    config = _r50_config(epochs=R50_STEPS, inverse_method='newton')
    ms: dict = {'off': [], 'on': []}
    for det in (False, True, True, False):
        torch.backends.cudnn.deterministic = det
        res = train_imagenet_resnet.train(config, device='cuda')
        res.pop('state')
        ms['on' if det else 'off'].append(
            statistics.median(_step_ms(res)[1]))
        _release()
    torch.backends.cudnn.deterministic = False
    seconds = time.perf_counter() - t0
    log(f'  phase 6 non-firing ms/step (median of {R50_STEPS - 2}), '
        f'deterministic cuDNN off {[round(v, 2) for v in ms["off"]]}, on '
        f'{[round(v, 2) for v in ms["on"]]}; probe {seconds:.1f} s wall '
        f'({card})')
    return {'differing_leaves': n, 'max_abs_diff': worst, 'where': where,
            'nonfiring_ms': ms, 'seconds': seconds}


def run_resume_phases(card: str, after_28=()) -> dict:
    """Phases 27 and 28 at once, with their wall time; this process's
    cached device memory is released first (the phases' subprocesses share
    the card). Phase 28's gloo worlds run in a thread beside phase 27's
    ResNet-50 runs (neither times anything the other perturbs but its own
    runs' walls and saves); its lines are printed after phase 27's.
    ``after_28``: ``(fn, *args)`` calls of subprocess gloo worlds run one
    after the other in phase 28's thread once its worlds are done, on the
    host cores phase 27's tail (three ResNet-50 runs on the card) leaves
    idle; their results are ``out['after_28']``."""
    import shutil
    import tempfile
    import torch
    _release()
    t0 = time.perf_counter()
    free = shutil.disk_usage(tempfile.gettempdir()).free
    log(f'== checkpoint and resume, phases 27 and 28 at once ('
        f'{free / 2**30:.1f} GiB free in {tempfile.gettempdir()}, '
        f'{torch.cuda.mem_get_info()[0] / 2**30:.1f} GiB on the card)'
        + (f'; {len(after_28)} more gloo worlds after phase 28\'s'
           if after_28 else ''))

    def worlds():
        return [run_resume_gloo_world(card)] + [fn(*args)
                                                for fn, *args in after_28]

    resnet50, (gloo_world, *more) = at_once((run_resume_resnet50, card),
                                            (worlds,))
    out = {'resume_resnet50': resnet50, 'resume_gloo_world': gloo_world}
    if after_28:
        out['after_28'] = more
    seconds = time.perf_counter() - t0
    log(f'  phases 27-28: {seconds:.1f} s wall ({card})')
    out['resume_seconds'] = seconds
    return out


def at_once(*calls, here: bool = False) -> list:
    """Run ``(fn, *args)`` calls at once, each in a thread, and return
    their results in order; each call's :func:`log` lines are kept and
    printed after the call before it has printed its own, so the output
    reads as if they had run one after the other. A call that raises
    re-raises here, after the calls before it have printed. ``here``: the
    first call runs on this thread (a CLI run that installs signal
    handlers must run on the main thread)."""
    from concurrent.futures import Future, ThreadPoolExecutor

    def logged(lines, fn, *args):
        _LOG_BUFFER.lines = lines
        try:
            return fn(*args)
        finally:
            _LOG_BUFFER.lines = None

    buffers = [[] for _ in calls]
    with ThreadPoolExecutor(len(calls)) as pool:
        start = 1 if here else 0
        futures = [pool.submit(logged, buf, *call)
                   for buf, call in zip(buffers[start:], calls[start:])]
        if here:
            first = Future()
            try:
                first.set_result(logged(buffers[0], *calls[0]))
            except BaseException as exc:
                first.set_exception(exc)
            futures.insert(0, first)
        results = []
        for buf, fut in zip(buffers, futures):
            exc = fut.exception()
            for line in buf:
                log(line)
            if exc is not None:
                raise exc
            results.append(fut.result())
    return results


def _bundle_figures(directory: Path, card: str) -> dict:
    """The final ResNet-50 bundle's bytes; the restore (read, verify,
    onto the card), the checksum alone and the blocking save (the
    manager's checksum and write), each measured twice."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.resilience import integrity
    from distributed_kfac_pytorch_tpu_torch.training.checkpoint import \
        CheckpointManager
    nbytes = sum(p.stat().st_size for p in (directory / '1').iterdir())
    mgr = CheckpointManager(str(directory))
    out = {'bytes': nbytes, 'restore_ms': [], 'checksum_ms': [],
           'save_ms': []}
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tree = mgr.restore(1, map_location='cuda')
        torch.cuda.synchronize()
        out['restore_ms'].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        integrity.tree_checksum(tree)
        out['checksum_ms'].append((time.perf_counter() - t) * 1e3)
        writer = CheckpointManager(str(directory / 'write'))
        t = time.perf_counter()
        writer.save(i, tree)
        out['save_ms'].append((time.perf_counter() - t) * 1e3)
        del tree

    def ms(key):
        return [round(v, 1) for v in out[key]]

    log(f'  ResNet-50 bundle: {nbytes} bytes; blocking save (checksum, '
        f'write) ms {ms("save_ms")}; the checksum alone '
        f'{ms("checksum_ms")}; restore (read, verify, onto the card) ms '
        f'{ms("restore_ms")} ({card})')
    return out


_PORTS_LOCK = threading.Lock()
_PORTS_TAKEN: set = set()


def _world_run(directory: Path, chaos: str | None = None,
               sigterm_after: str | None = None, flags=()) -> tuple:
    """GLOO_WORLD ranks of the CIFAR CLI (module entry point) on cuda:0:
    ``(exit codes, outputs)``. ``sigterm_after``: send SIGTERM to rank 0
    alone once its output shows that line."""
    import signal
    import socket
    with _PORTS_LOCK:
        # Worlds start at once: never hand a free port out twice.
        port = 0
        while port == 0 or port in _PORTS_TAKEN:
            with socket.socket() as s:
                s.bind(('localhost', 0))
                port = s.getsockname()[1]
        _PORTS_TAKEN.add(port)
    procs = []
    for rank in range(GLOO_WORLD):
        env = _resume_env(chaos, RANK=str(rank), WORLD_SIZE=str(GLOO_WORLD),
                          LOCAL_RANK='0', MASTER_ADDR='localhost',
                          MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            _cli_argv('train_cifar10_resnet', [*RESUME_R32, *flags],
                      directory),
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [[] for _ in procs]

    def drain(i: int) -> None:
        for line in procs[i].stdout:
            outs[i].append(line)
            if i == 0 and sigterm_after and line.startswith(sigterm_after):
                procs[0].send_signal(signal.SIGTERM)

    readers = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in readers:
        t.start()
    deadline = time.monotonic() + RESUME_WORLD_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in readers:
            t.join(timeout=30)
    return [p.returncode for p in procs], [''.join(o) for o in outs]


def run_resume_gloo_world(card: str) -> dict:
    """Phase 28: the CIFAR CLI on GLOO_WORLD gloo ranks of the card: a
    real SIGTERM on rank 0 alone drains every rank at one step into one
    bundle of every rank's file, and the relaunch ends equal, file by
    file, to the uninterrupted run; a bundle bit-rotted at step 6, then a
    crash at step 7: the relaunch quarantines label 6 with its reason and
    resumes from label 3. The uninterrupted world and the two interrupted
    ones run at once, then the two relaunches."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from distributed_kfac_pytorch_tpu_torch.training.checkpoint import \
        RANK_FILE

    log(f'  phase 28: ResNet-32, {GLOO_WORLD} gloo ranks of the CIFAR CLI on '
        'one card, hybrid-opt 2 x 2, 2 epochs of 8 steps, jacobi: SIGTERM '
        'on rank 0, then corrupt-ckpt@6,crash@7 (three worlds at once, then '
        'two)')
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix='kfac-resume-world-'))
    launches: dict = {}
    out = {}
    files = ['bundle.pt'] + [RANK_FILE.format(r) for r in range(GLOO_WORLD)]

    def world(name, want_rc, **kw):
        rcs, outs = _world_run(tmp / name, **kw)
        if rcs != [want_rc] * GLOO_WORLD:
            raise AssertionError(f'{name}: exits {rcs}, expected {want_rc}\n'
                                 f'{outs[0][-4000:]}')
        return outs

    def wave(*runs) -> list:
        with ThreadPoolExecutor(len(runs)) as pool:
            done = [f.result() for f in
                    [pool.submit(world, *a, **kw) for a, kw in runs]]
        for name in {a[0] for a, _ in runs}:
            _add(launches, _launches_of(tmp / name, GLOO_WORLD))
        return done

    # SIGTERM on rank 0 alone, once it has saved step 6 (past step 5). Bit
    # rot at step 6 is not paired with preempt@6: its forced save would
    # replace the corrupted label.
    _, sig_outs, _ = wave(
        (('ref', 0), {}),
        (('sigterm', 75), {'sigterm_after': 'checkpoint: step 6 saved'}),
        (('corrupt', 137), {'chaos': 'corrupt-ckpt@6,crash@7'}))
    last = tmp / 'ref' / '1'     # the final epoch bundle
    drained = set()
    for o in sig_outs:
        drained |= {ln.split('at global step ')[1].split(';')[0]
                    for ln in o.splitlines() if ln.startswith('preempted (')}
    if len(drained) != 1:
        raise AssertionError(f'ranks drained at steps {drained}')
    step = int(drained.pop())
    got = sorted(os.listdir(tmp / 'sigterm' / 'steps' / str(step)))
    if got != sorted(files):
        raise AssertionError(f'steps/{step} holds {got}')
    log(f'  SIGTERM to rank 0 after its step-6 save: all {GLOO_WORLD} ranks '
        f'drained at global step {step} (exit 75), steps/{step} holds {got}')
    save_ms = [float(ln.split(' saved in ')[1].split()[0])
               for ln in sig_outs[0].splitlines()
               if ln.startswith('checkpoint: step ')]
    log(f'  rank 0 blocking step saves under the group (its files and '
        f'bundle.pt, each hashed once), ms {save_ms} ({card})')
    sig_outs, cor_outs = wave((('sigterm', 0), {}), (('corrupt', 0), {}))
    out['sigterm'] = {'drained_at': step, 'save_ms': save_ms,
                      'resumed': _resumed_line(sig_outs[0]),
                      'held': _held_to('SIGTERM relaunch',
                                       tmp / 'sigterm' / '1', last)}
    text = cor_outs[0]
    quarantine = [ln for ln in text.splitlines()
                  if 'quarantining step checkpoint 6' in ln]
    line = _resumed_line(text)
    if not quarantine or 'step checkpoint 3' not in line:
        raise AssertionError(f'corrupt case: {quarantine}, {line}')
    reason = (tmp / 'corrupt' / 'steps' / '6.quarantined' /
              'QUARANTINE_REASON').read_text().strip()
    log(f'  corrupt-ckpt@6,crash@7: label 6 quarantined ({reason}); '
        f'relaunch {line}')
    out['corrupt'] = {'reason': reason, 'resumed': line,
                      'held': _held_to('corrupt relaunch', tmp / 'corrupt' /
                                       '1', last)}
    seconds = time.perf_counter() - t0
    log(f'  launches {launches}; phase 28: {seconds:.1f} s wall ({card})')
    shutil.rmtree(tmp, ignore_errors=True)
    return {**out, 'launches': launches, 'seconds': seconds}


# ---------------------------------------------------------------------------
# Phases 29-31: gradient accumulation, remat, precise-BN
# ---------------------------------------------------------------------------

# Phase 29: the ImageNet CLI at ResNet-50, 224 px, batch 256 as 4
# micro-batches of 64, newton, one fixed batch, 12 steps (firings at 0 and
# 10): K1 and K2 run once per micro-batch on factor steps, K3 once per
# step, K4 once per size bucket per firing.
ACCUM_BATCH, ACCUM_N, ACCUM_STEPS = 256, 4, 12
# Peak device memory of ResNet-50 under newton (2 steps, one firing) at
# batch 64 and at batch 256 in one pass, beside the accumulated run's.
# The one-pass case runs because the builder's probe on the H100
# (``scripts/accum_memory_probe.py``) showed it fits (PERF.md §6); an
# out-of-memory error there fails the phase.
ACCUM_MEMORY_CASES = ((R50_BATCH, 1), (ACCUM_BATCH, 1))
# Then the CIFAR CLI at ResNet-32 GN, batch 512, --grad-accum 4 against
# --grad-accum 1, 3 steps (inverses every 2nd, exact eigh: the warm
# polish's basis is sensitive to fp32 summation order), held: every
# step's loss 1e-5 relative, the final factors within 1e-5 of the largest
# entry, the first step's preconditioned gradients (one step each, from
# the same parameters) within 1e-4 of the largest entry of all of them
# (the largest gaps per tensor, relative to the tensor's own largest
# entry, are printed: the GN net's initial logits are large, so the
# forward's convolution sums, taken in another order at batch 128 than
# at 512, move a small cancelling gradient such as the head's bias by up
# to ~5e-4 of itself on the H100). The final step's gradients are
# printed, not held: the K-FAC updates amplify the first step's gap (a
# CPU rehearsal at batch 64: 3e-5 at step 0, 1e-3 at step 1, 1e-2 at
# step 2; the JAX suite holds its accumulated run at rtol 1e-2).
ACCUM_GN_BATCH, ACCUM_GN_STEPS = 512, 3
ACCUM_GN_TOL = {'factors': 1e-5, 'precond': 1e-4, 'loss': 1e-5}
# Phase 30: ResNet-50 with --remat against without, --deterministic, 3
# steps (a firing at step 0), at each batch; held within these relative
# to the largest entry (bit for bit expected: the recomputation repeats
# the forward pass's deterministic arithmetic).
REMAT_BATCHES, REMAT_STEPS = (R50_BATCH, 2 * R50_BATCH), 3
REMAT_TOL = {'loss': 1e-6, 'factors': 1e-5, 'precond': 1e-4,
             'buffers': 1e-5}
# Phase 31: --precise-bn-batches 4 on the ImageNet CLI (ResNet-50, 224
# px, batch 64, one epoch of 4 steps): the evaluation's statistics within
# 1e-5 of the plain average taken by hand; then ResNet-32 GN on the 4
# gloo ranks at world batch GLOO_BATCH with grad_accum 2, each step held
# to the single-device single pass at STEP_TOL (the preconditioned
# gradients relative to the largest entry of all of them).
PRECISE_BN_BATCHES, PRECISE_BN_TOL = 4, 1e-5
ACCUM_GLOO_N = 2
ACCUM_GLOO_CASES = (('comm_opt', 'comm-opt', 0.0, (1, 4)),
                    ('hybrid_opt', 'hybrid-opt', 0.5, (2, 2)))


def _gib(n: float) -> float:
    return n / 2 ** 30


def _measured_run(module, config: dict) -> tuple[dict, dict, float]:
    """A CLI's ``train`` on the card with the launch counts reset just
    before and read just after; returns ``(result, launches, peak GiB)``,
    the peak of allocated device memory above what was allocated when it
    started."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    _release()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = module.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    peak = _gib(torch.cuda.max_memory_allocated() - base)
    return res, launches, peak


@contextlib.contextmanager
def _cudnn_flags():
    """cuDNN's determinism flags as they were after the block (the CLIs'
    ``--deterministic`` sets them for the process)."""
    import torch
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def _tensor_rel(got, want) -> float:
    """``max|got - want| / max|want|`` of two tensors (0 when equal)."""
    import torch
    if torch.equal(got, want):
        return 0.0
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _state_gaps(a, b) -> dict:
    """Largest relative gaps of two runs' final states: factors,
    preconditioned gradients (``p.grad`` after the last step), buffers;
    and whether each is bit for bit."""
    import torch
    sa, sb = a['state'], b['state']
    pairs = {
        'factors': [(sa.kfac_state['factors'][n][s],
                     sb.kfac_state['factors'][n][s])
                    for n in sb.kfac_state['factors'] for s in 'AG'],
        'precond': [(pa.grad, pb.grad) for (_, pa), (_, pb) in zip(
            sa.model.named_parameters(), sb.model.named_parameters())],
        'buffers': [(x, y) for (_, x), (_, y) in zip(
            sa.model.named_buffers(), sb.model.named_buffers())
            if y.is_floating_point()]}
    out = {}
    for key, ps in pairs.items():
        out[key] = max((_tensor_rel(x, y) for x, y in ps), default=0.0)
        out[f'{key}_bitwise'] = all(torch.equal(x, y) for x, y in ps)
    out['counters_equal'] = all(
        torch.equal(x, y) for (_, x), (_, y) in zip(
            sa.model.named_buffers(), sb.model.named_buffers())
        if not y.is_floating_point())
    return out


def _grad_gaps(a, b) -> tuple[list, float]:
    """The preconditioned gradients (``p.grad`` after the last step) of
    two runs: per tensor the largest gap relative to the tensor's largest
    entry (worst first), and the largest gap of all relative to the
    largest entry of all."""
    per, gap, top = [], 0.0, 0.0
    for (name, pa), (_, pb) in zip(a['state'].model.named_parameters(),
                                   b['state'].model.named_parameters()):
        per.append({'name': name, 'entry': _tensor_rel(pa.grad, pb.grad)})
        gap = max(gap, float((pa.grad - pb.grad).abs().max()))
        top = max(top, float(pb.grad.abs().max()))
    return sorted(per, key=lambda w: -w['entry']), gap / max(top, 1e-30)


def run_grad_accum(card: str) -> dict:
    """Phase 29: ResNet-50 at batch 256 as 4 micro-batches through the
    ImageNet CLI; the peak memory cases; ResNet-32 GN accumulated against
    its single pass through the CIFAR CLI."""
    from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet, \
        train_imagenet_resnet
    config = _r50_config(batch_size=ACCUM_BATCH, synthetic_size=ACCUM_BATCH,
                         grad_accum=ACCUM_N, epochs=ACCUM_STEPS,
                         inverse_method='newton')
    res, launches, peak = _measured_run(train_imagenet_resnet, config)
    res.pop('state')
    losses, n = res['losses'], res['steps']
    log(f'  batch {ACCUM_BATCH} as {ACCUM_N} x {ACCUM_BATCH // ACCUM_N}: '
        f'losses {[round(v, 4) for v in losses]}')
    if n != ACCUM_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'grad accum: {n} steps, losses {losses}')
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'grad accum: loss did not decrease: first '
                             f'three {first:.4f}, last three {last:.4f}')
    firings = res['fired'].count('inverse')
    # The single pass's plan, extended: K1 and K2 once per micro-batch.
    expected = {'factor_ema': R50_PER_STEP['factor_ema'] * ACCUM_N * n,
                'patch_cov': R50_PER_STEP['patch_cov'] * ACCUM_N * n,
                'bucket_precond': R50_PER_STEP['bucket_precond'] * n,
                'ns_inverse': R50_PER_FIRING * firings, 'jacobi_eigh': 0}
    if launches != expected:
        raise AssertionError(f'grad accum: launches {launches}, expected '
                             f'{expected}')
    firing, plain = _step_ms(res)
    summary = {'losses': losses, 'launches': launches, 'firings': firings,
               'nonfiring_ms_median': statistics.median(plain),
               'firing_ms': firing, 'peak_gib': peak}
    log(f'  launches {launches} = {ACCUM_N} x K1/K2 per factor step; '
        f'non-firing {summary["nonfiring_ms_median"]:.2f} ms (median), '
        f'firing {[round(t, 1) for t in firing]} ms; peak '
        f'{peak:.2f} GiB ({card})')
    memory = [{'batch': ACCUM_BATCH, 'grad_accum': ACCUM_N,
               'peak_gib': peak, 'step_ms': res['step_ms']}]
    for batch, accum in ACCUM_MEMORY_CASES:
        mres, _, mpeak = _measured_run(train_imagenet_resnet, _r50_config(
            batch_size=batch, synthetic_size=batch, grad_accum=accum,
            epochs=2, inverse_method='newton'))
        mres.pop('state')
        if not all(math.isfinite(v) for v in mres['losses']):
            raise AssertionError(f'memory case {batch} x{accum}: losses '
                                 f'{mres["losses"]}')
        memory.append({'batch': batch, 'grad_accum': accum,
                       'peak_gib': mpeak, 'step_ms': mres['step_ms']})
        log(f'  ResNet-50 batch {batch}, --grad-accum {accum}: peak '
            f'{mpeak:.2f} GiB above the process baseline; step ms '
            f'{[round(t, 1) for t in mres["step_ms"]]} ({card})')
    summary['memory'] = memory
    # ResNet-32 GN: --grad-accum 4 against the single pass, 3 steps and
    # the first step alone.
    gn = {}
    with _cudnn_flags():
        for accum in (1, ACCUM_N):
            for steps in (1, ACCUM_GN_STEPS):
                gres, glaunch, _ = _measured_run(train_cifar10_resnet, {
                    'model': 'resnet32gn', 'batch_size': ACCUM_GN_BATCH,
                    'synthetic_size': ACCUM_GN_BATCH,
                    'val_batch_size': ACCUM_GN_BATCH // 4, 'epochs': steps,
                    'no_augment': True, 'seed': 0, 'kfac_update_freq': 2,
                    'kfac_cov_update_freq': 1, 'eigh_method': 'xla',
                    'grad_accum': accum, 'deterministic': True,
                    'time_steps': True, 'quiet': True})
                want = {'factor_ema': R32_PER_STEP_K1 * accum * steps,
                        'patch_cov': R32_PER_STEP_K2 * accum * steps}
                if {k: glaunch[k] for k in want} != want:
                    raise AssertionError(f'resnet32gn x{accum}: launches '
                                         f'{glaunch}, expected {want}')
                gn[accum, steps] = (gres, glaunch)
    (one, l1), (acc, l4) = gn[1, ACCUM_GN_STEPS], gn[ACCUM_N, ACCUM_GN_STEPS]
    gaps = _state_gaps(acc, one)
    gaps['loss'] = max(abs(a - b) / abs(b) for a, b in
                       zip(acc['losses'], one['losses']))
    worst, gaps['precond'] = _grad_gaps(gn[ACCUM_N, 1][0], gn[1, 1][0])
    gaps['precond_final'] = _grad_gaps(acc, one)[1]
    gaps['precond_tensors'] = worst[:3]
    log(f'  ResNet-32 GN batch {ACCUM_GN_BATCH}, --grad-accum {ACCUM_N} vs '
        f'1 over {ACCUM_GN_STEPS} steps: losses '
        f'{[round(v, 5) for v in acc["losses"]]} vs '
        f'{[round(v, 5) for v in one["losses"]]}; largest gaps: losses '
        f'{gaps["loss"]:.2e}, final factors {gaps["factors"]:.2e}, '
        f'first step\'s preconditioned grads {gaps["precond"]:.2e} of the '
        f'largest entry (limits {ACCUM_GN_TOL}); per tensor, of its own '
        f'largest: {[(w["name"], f"{w["entry"]:.2e}") for w in worst[:3]]}; '
        f'final step\'s {gaps["precond_final"]:.2e} (not held); step ms '
        f'{[round(t, 1) for t in acc["step_ms"]]} vs '
        f'{[round(t, 1) for t in one["step_ms"]]}')
    bad = {k: gaps[k] for k in ACCUM_GN_TOL if not gaps[k] <= ACCUM_GN_TOL[k]}
    if bad:
        raise AssertionError(f'resnet32gn accumulated vs single pass: {bad}')
    launches_all = dict(launches)
    for (accum, steps), (r, lc) in gn.items():
        r.pop('state')
        if steps == ACCUM_GN_STEPS:
            launches_all = {k: launches_all[k] + lc.get(k, 0)
                            for k in launches_all}
    summary.update({'resnet32gn': {'gaps': gaps, 'losses_accum':
                                   acc['losses'], 'losses_single':
                                   one['losses'], 'step_ms_accum':
                                   acc['step_ms'], 'step_ms_single':
                                   one['step_ms'], 'launches_accum': l4,
                                   'launches_single': l1},
                    'launches': launches_all})
    return summary


def run_remat(card: str) -> dict:
    """Phase 30: ResNet-50 with and without --remat, --deterministic, at
    each batch of REMAT_BATCHES: the runs held equal; peak memory and
    step ms of each."""
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    out = {'cases': [], 'launches': {}}
    with _cudnn_flags():
        for batch in REMAT_BATCHES:
            runs = {}
            for remat in (False, True):
                config = _r50_config(batch_size=batch, synthetic_size=batch,
                                     val_batch_size=R50_BATCH,
                                     epochs=REMAT_STEPS, remat=remat,
                                     deterministic=True)
                res, launches, peak = _measured_run(train_imagenet_resnet,
                                                    config)
                expected = {name: per * REMAT_STEPS
                            for name, per in R50_PER_STEP.items()}
                expected['ns_inverse'] = expected['jacobi_eigh'] = 0
                if launches != expected:
                    raise AssertionError(f'remat={remat} batch {batch}: '
                                         f'launches {launches}')
                if res['state'].model.remat is not remat:
                    raise AssertionError('remat flag not on the model')
                for k, v in launches.items():
                    out['launches'][k] = out['launches'].get(k, 0) + v
                runs[remat] = (res, peak)
            (plain, p_peak), (remat, r_peak) = runs[False], runs[True]
            gaps = _state_gaps(remat, plain)
            gaps['loss'] = max(abs(a - b) / abs(b) for a, b in
                               zip(remat['losses'], plain['losses']))
            gaps['loss_bitwise'] = remat['losses'] == plain['losses']
            p_ms = statistics.median(plain['step_ms'][1:])
            r_ms = statistics.median(remat['step_ms'][1:])
            case = {'batch': batch, 'gaps': gaps,
                    'peak_gib': {'plain': p_peak, 'remat': r_peak},
                    'nonfiring_ms': {'plain': p_ms, 'remat': r_ms},
                    'step_ms': {'plain': plain['step_ms'],
                                'remat': remat['step_ms']},
                    'losses': plain['losses']}
            log(f'  batch {batch}: peak {p_peak:.2f} -> {r_peak:.2f} GiB '
                f'with --remat; non-firing step {p_ms:.2f} -> {r_ms:.2f} '
                f'ms (x{r_ms / p_ms:.3f}); largest gaps: loss '
                f'{gaps["loss"]:.2e}, factors {gaps["factors"]:.2e}, '
                f'preconditioned grads {gaps["precond"]:.2e}, BN buffers '
                f'{gaps["buffers"]:.2e}; bit for bit: '
                f'{ {k[:-8]: v for k, v in gaps.items() if k.endswith("_bitwise")} }'
                f', counters equal {gaps["counters_equal"]} ({card})')
            bad = {k: gaps[k] for k in REMAT_TOL
                   if not gaps[k] <= REMAT_TOL[k]}
            if bad or not gaps['counters_equal']:
                raise AssertionError(f'remat batch {batch}: {bad}')
            plain.pop('state')
            remat.pop('state')
            out['cases'].append(case)
    return out


def run_precise_bn(card: str) -> dict:
    """Phase 31, first part: --precise-bn-batches through the ImageNet
    CLI at ResNet-50; the evaluation's statistics against the plain
    average taken by hand over the same batches at the same weights, the
    training statistics back bit for bit."""
    import copy

    import numpy as np
    import torch
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.training import datasets, engine
    seen = {}
    recalibrate, evaluate = engine.precise_bn_recalibrate, engine.evaluate

    def spy_recalibrate(model, batches, **kw):
        batches = list(batches)
        seen.update(batches=batches, model=copy.deepcopy(model),
                    training={k: v.clone()
                              for k, v in model.state_dict().items()})
        t0 = time.perf_counter()
        out = recalibrate(model, batches, **kw)
        torch.cuda.synchronize()
        seen['recal_ms'] = (time.perf_counter() - t0) * 1e3
        return out

    def spy_evaluate(model, batches, **kw):
        seen['eval'] = {k: v.clone() for k, v in model.state_dict().items()}
        return evaluate(model, batches, **kw)

    steps = PRECISE_BN_BATCHES
    config = _r50_config(synthetic_size=steps * R50_BATCH, epochs=1,
                         precise_bn_batches=PRECISE_BN_BATCHES)
    engine.precise_bn_recalibrate, engine.evaluate = (spy_recalibrate,
                                                      spy_evaluate)
    try:
        res, launches, _ = _measured_run(train_imagenet_resnet, config)
    finally:
        engine.precise_bn_recalibrate, engine.evaluate = (recalibrate,
                                                          evaluate)
    expected = {name: per * steps for name, per in R50_PER_STEP.items()}
    expected['ns_inverse'] = expected['jacobi_eigh'] = 0
    if launches != expected:
        raise AssertionError(f'precise-BN: launches {launches}')
    train_data, _ = datasets.get_imagenet(
        None, image_size=config['image_size'],
        synthetic_size=steps * R50_BATCH)
    stream = datasets.epoch_batches(*train_data, R50_BATCH, seed=0, epoch=0)
    want = [next(stream) for _ in range(PRECISE_BN_BATCHES)]
    if not all(np.array_equal(g[0], w[0]) for g, w in
               zip(seen['batches'], want)):
        raise AssertionError('precise-BN: not the epoch stream\'s first '
                             'batches')
    # By hand: each BatchNorm's input per batch, training mode, float64.
    model = seen['model']
    sums, hooks = {}, []

    def hook(mod, inp, name):
        x = inp[0].double()
        m, v = sums.get(name, (0.0, 0.0))
        sums[name] = (m + x.mean(dim=(0, 2, 3)),
                      v + x.var(dim=(0, 2, 3), unbiased=True))

    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, inp, name=name: hook(m, inp, name)))
    model.train()
    with torch.no_grad():
        for x, _ in want:
            model(torch.as_tensor(x, device='cuda'))
    for h in hooks:
        h.remove()
    gaps = {'mean': 0.0, 'var': 0.0}
    for name, (m, v) in sums.items():
        for key, hand in (('mean', m), ('var', v)):
            hand = (hand / PRECISE_BN_BATCHES).float()
            got = seen['eval'][f'{name}.running_{key}']
            gaps[key] = max(gaps[key], _tensor_rel(got, hand))
    final = res.pop('state').model.state_dict()
    restored = all(torch.equal(final[k], v)
                   for k, v in seen['training'].items())
    moved = max(_tensor_rel(seen['eval'][k], v)
                for k, v in seen['training'].items()
                if k.endswith('running_var'))
    log(f'  {PRECISE_BN_BATCHES} batches of {R50_BATCH}, {len(sums)} '
        f'BatchNorms: recalibrated against by hand: means '
        f'{gaps["mean"]:.2e}, variances {gaps["var"]:.2e} (limit '
        f'{PRECISE_BN_TOL}); the EWMA variances they replaced differ by up '
        f'to {moved:.2e}; training buffers back bit for bit: {restored}; '
        f'recalibration {seen["recal_ms"]:.1f} ms ({card})')
    if not (gaps['mean'] <= PRECISE_BN_TOL and gaps['var'] <= PRECISE_BN_TOL
            and restored):
        raise AssertionError(f'precise-BN: {gaps}, restored {restored}')
    return {'gaps': gaps, 'restored': restored, 'ewma_gap': moved,
            'recal_ms': seen['recal_ms'], 'launches': launches,
            'losses': res['losses']}


def accum_dist_worker(cfg: dict) -> int:
    """One rank of phase 31's world (``--dist-worker`` with phase
    ``'resnet32gn_accum'``): ResNet-32 GN at full width, this rank's slice
    of one global batch as ACCUM_GLOO_N micro-batches
    (``engine.accumulate_pass``), ``DistributedKFAC.step(contribs=)``;
    rank 0 holds each step against the single-device ``KFAC`` single pass
    on the full batch at STEP_TOL (and the loss at 1e-5), the
    preconditioned gradients relative to the largest entry of all of them
    (as phase 29's GN comparison; the largest per-tensor gap is printed:
    it reached 1.05e-4 at a third hybrid-opt step on the H100, where the
    K-FAC updates amplify the two fp32 summation orders' gap in a small
    tensor)."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch import launch, \
        set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine

    set_fp32_precision()
    meta = launch.initialize_distributed(
        init_method=f'file://{cfg["store"]}', backend='gloo',
        device='cuda:0', timeout=600)
    rank, dev = meta['process_index'], torch.device('cuda:0')
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(GLOO_BATCH, 3, 32, 32, generator=gen).to(dev)
    y = torch.randint(0, 10, (GLOO_BATCH,), generator=gen).to(dev)
    local = launch.process_local_slice(GLOO_BATCH)
    torch.manual_seed(0)
    model = cifar_resnet.get_model('resnet32gn').to(dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    knobs = dict(inverse_method='eigen', eigh_method='xla',
                 factor_update_freq=1, inv_update_freq=GLOO_INV_FREQ,
                 damping=0.003, lr=0.1, kl_clip=0.001, device=dev)
    report = {'rank': rank, 'cases': []}
    failures = []
    for name, comm, frac, grid in ACCUM_GLOO_CASES:
        model.load_state_dict(init)
        kfac = KFAC(model, **knobs)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac)
        ts = engine.TrainState(model=model, optimizer=None, kfac=dk,
                               kfac_state=dk.init_state(), distributed=True,
                               grad_accum=ACCUM_GLOO_N)
        work = dk.local_work()
        ref = ref_state = None
        if rank == 0:
            ref = KFAC(model, **knobs)
            ref_state = ref.init_state()
        launches = dict.fromkeys(kernels.LAUNCHES, 0)
        errors, step_ms = [], []
        for step in range(GLOO_STEPS):
            inv = step % GLOO_INV_FREQ == 0
            torch.cuda.synchronize()
            dist.barrier()
            kernels.reset_launches()
            t0 = time.perf_counter()
            loss, _, grads, captures, contribs = engine.accumulate_pass(
                ts, x[local], y[local], factor_update=True)
            *means, loss = engine.world_mean([*grads.values(), loss])
            grads = dict(zip(grads, means))
            precond, ts.kfac_state = dk.step(
                ts.kfac_state, grads, captures, contribs=contribs,
                factor_update=True, inv_update=inv)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
            if rank == 0:
                r_loss, _, g_full, c_full = ref.capture.loss_and_grads(
                    lambda out: F.cross_entropy(out, y), x)
                p_ref, ref_state = ref.step(ref_state, g_full, c_full,
                                            factor_update=True,
                                            inv_update=inv)
                gap = max(float((precond[n] - p_ref[n]).abs().max())
                          for n in p_ref)
                top = max(float(p_ref[n].abs().max()) for n in p_ref)
                err = {'factors': _max_rel(
                           (ts.kfac_state['factors'][n][s],
                            ref_state['factors'][n][s])
                           for n in ref.specs for s in 'AG'),
                       'precond': gap / top,
                       'precond_per_tensor': _max_rel(
                           (precond[n], p_ref[n]) for n in p_ref),
                       'nu': _max_rel([(dk.last_nu, ref.last_nu)]),
                       'loss': float(abs(loss - r_loss) / abs(r_loss))}
                errors.append(err)
                bad = {k: err[k] for k in ('factors', 'precond', 'nu', 'loss')
                       if not err[k] <= STEP_TOL.get(k, 1e-5)}
                if bad:
                    failures.append(f'{name} step {step}: {bad}')
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p -= 0.1 * precond[n]
        expected = dict.fromkeys(kernels.LAUNCHES, 0)
        expected.update({
            'factor_ema': R32_PER_STEP_K1 * ACCUM_GLOO_N * GLOO_STEPS,
            'patch_cov': R32_PER_STEP_K2 * ACCUM_GLOO_N * GLOO_STEPS,
            'bucket_precond': len(work['precondition']) * GLOO_STEPS})
        if launches != expected:
            failures.append(f'{name}: rank {rank} launches {launches}, '
                            f'expected {expected}')
        if (dk.n_rows, dk.n_cols) != grid:
            failures.append(f'{name}: grid {(dk.n_rows, dk.n_cols)}')
        report['cases'].append({
            'name': name, 'grid': [dk.n_rows, dk.n_cols], 'row': dk.row,
            'col': dk.col, 'launches': launches, 'expected': expected,
            'errors': errors, 'step_ms': step_ms})
        kfac.capture.close()
        if ref is not None:
            ref.capture.close()
    report['failures'] = failures
    Path(cfg['out']).write_text(json.dumps(report, indent=1))
    dist.destroy_process_group()
    return 1 if failures else 0


def run_accum_gloo_world(card: str) -> dict:
    """Phase 31, second part: ResNet-32 GN on GLOO_WORLD gloo ranks with
    grad_accum ACCUM_GLOO_N; fails if any rank fails."""
    log(f'  phase 31\'s world: ResNet-32 GN, {GLOO_WORLD} gloo ranks on one '
        f'card, world batch {GLOO_BATCH} with grad_accum {ACCUM_GLOO_N}, '
        f'{len(ACCUM_GLOO_CASES)} mesh cases x {GLOO_STEPS} steps')
    reports = _run_gloo_ranks('resnet32gn_accum', timeout=300)
    worst = {}
    for i, case in enumerate(reports[0]['cases']):
        errs = case['errors']
        worst[case['name']] = w = {k: max(e[k] for e in errs)
                                   for k in errs[0]}
        log(f'  {case["name"]} grid {case["grid"]}, {ACCUM_GLOO_N} '
            f'micro-batches of {GLOO_BATCH // GLOO_WORLD // ACCUM_GLOO_N} '
            f'per rank: rank 0 vs the single-device single pass over '
            f'{len(errs)} steps: factors {w["factors"]:.2e}, preconditioned '
            f'grads {w["precond"]:.2e} of the largest entry (per tensor '
            f'{w["precond_per_tensor"]:.2e}, not held), nu {w["nu"]:.2e}, '
            f'loss {w["loss"]:.2e} (limits {STEP_TOL}, loss 1e-5)')
        for rep in reports:
            c = rep['cases'][i]
            log(f'    rank {rep["rank"]} (row {c["row"]}, col {c["col"]}): '
                f'launches { {k: v for k, v in c["launches"].items() if v} }'
                f'; step ms {[round(t, 1) for t in c["step_ms"]]}')
    total = _launch_total(reports)
    log(f'  all ranks: launches {total} ({card})')
    return {'launches': total, 'worst': worst, 'ranks': reports}


def run_accum_phases(card: str, accum_world: dict | None = None) -> dict:
    """Phases 29-31 with their wall time; ``accum_world`` is phase 31's
    gloo world when it ran beside phase 14 (else it runs here)."""
    t0 = time.perf_counter()
    log(f'== gradient accumulation: the ImageNet CLI at ResNet-50, 224 px, '
        f'batch {ACCUM_BATCH} as --grad-accum {ACCUM_N}, newton, '
        f'{ACCUM_STEPS} steps on one batch; peak memory beside it at batch '
        f'{R50_BATCH} and {ACCUM_BATCH} in one pass; the CIFAR CLI at '
        f'ResNet-32 GN, batch {ACCUM_GN_BATCH}, --grad-accum {ACCUM_N} '
        f'against 1, {ACCUM_GN_STEPS} steps')
    out = {'grad_accum': run_grad_accum(card)}
    t1 = time.perf_counter()
    log(f'  phase 29: {t1 - t0:.1f} s')
    log(f'== block rematerialization: ResNet-50 --remat against without, '
        f'--deterministic, batches {REMAT_BATCHES}, {REMAT_STEPS} steps')
    out['remat'] = run_remat(card)
    t2 = time.perf_counter()
    log(f'  phase 30: {t2 - t1:.1f} s')
    log(f'== precise-BN and distribution: the ImageNet CLI at ResNet-50 '
        f'with --precise-bn-batches {PRECISE_BN_BATCHES}; ResNet-32 GN, '
        f'{GLOO_WORLD} gloo ranks on one card, world batch {GLOO_BATCH} '
        f'with grad_accum {ACCUM_GLOO_N}, {len(ACCUM_GLOO_CASES)} mesh '
        f'cases x {GLOO_STEPS} steps'
        + (' (the world ran beside phase 14)' if accum_world else ''))
    out['precise_bn'] = run_precise_bn(card)
    out['accum_gloo_world'] = accum_world or run_accum_gloo_world(card)
    t3 = time.perf_counter()
    log(f'  phase 31: {t3 - t2:.1f} s')
    log(f'  phases 29-31: {t3 - t0:.1f} s wall ({card})')
    out['accum_seconds'] = {'29': t1 - t0, '30': t2 - t1, '31': t3 - t2,
                            'total': t3 - t0}
    return out


# ---------------------------------------------------------------------------
# Phases 32-33: MobileNetV1 (grouped / depthwise convs) and ViT-S/16
# ---------------------------------------------------------------------------

def _fixed_batch(batch: int, px: int, dev, seed: int = 0):
    """One synthetic ImageNet batch, ``(x, y)`` on ``dev``, from ``seed``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, 3, px, px), generator=gen)
    y = torch.randint(0, 1000, (batch,), generator=gen)
    return x.to(dev), y.to(dev)


def _mobilenet(dev):
    import torch
    from distributed_kfac_pytorch_tpu_torch.models import mobilenet
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(0)
        return mobilenet.get_model(1000).to(dev)


def _mobilenet_kfac(model, dev):
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    return KFAC(model, damping=MB_DAMPING, lr=MB_LR, factor_update_freq=1,
                inv_update_freq=MB_FIRE_EVERY, device=dev)


def _grouped_cov64(spec, a, g) -> dict:
    """One batch's per-group A and G of a grouped conv in float64, by
    ``F.unfold`` (independent of the port's strided-view im2col): the patch
    covariance of each group's channels over ``B*OH*OW`` rows and the
    covariance of its output-gradient block, each over ``rows *
    spatial^2``."""
    import torch
    import torch.nn.functional as F
    n = spec.feature_group_count
    (ph, _), (pw, _) = spec.padding
    p = F.unfold(a.double(), spec.kernel_size, padding=(ph, pw),
                 stride=spec.strides)                  # (B, C*kh*kw, L)
    b, _, spatial = p.shape
    p = p.reshape(b, n, -1, spatial).permute(1, 2, 0, 3).reshape(
        n, -1, b * spatial)
    g2 = g.double().reshape(b, n, -1, spatial).permute(1, 2, 0, 3).reshape(
        n, -1, b * spatial)
    scale = 1.0 / (b * spatial * spatial * spatial)
    return {'A': p @ p.mT * scale, 'G': g2 @ g2.mT * scale}


def run_mobilenet(card: str) -> dict:
    """Phase 32 (see the module docstring)."""
    import torch
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch import layers as L
    from distributed_kfac_pytorch_tpu_torch.capture import CONV2D_GROUPED
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    _release()
    t0 = time.perf_counter()
    dev = torch.device('cuda')
    x, y = _fixed_batch(MB_BATCH, MB_PX, dev)
    model = _mobilenet(dev)
    kfac = _mobilenet_kfac(model, dev)
    grouped = [n for n, sp in kfac.specs.items()
               if sp.kind == CONV2D_GROUPED]
    skipped = sorted(kfac.capture.skipped_modules)
    if len(grouped) != MB_GROUPED or len(kfac.specs) != 28 or any(
            'bn' not in n for n in skipped):
        raise AssertionError(f'MobileNetV1: {len(grouped)} grouped of '
                             f'{len(kfac.specs)} layers, skipped {skipped}')
    opt = torch.optim.SGD(model.parameters(), lr=MB_LR, momentum=0.9)
    state = kfac.init_state()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    kernels.reset_launches()
    for step in range(MB_STEPS):
        fire = step % MB_FIRE_EVERY == 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, y), x)
        prev = state['factors']
        precond, state = kfac.step(state, grads, captures,
                                   factor_update=True, inv_update=fire)
        for n, p in model.named_parameters():
            p.grad = precond[n]
        opt.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
    launches = dict(kernels.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f'  losses: {[round(v, 4) for v in losses]}')
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'MobileNetV1: losses {losses}')
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'MobileNetV1: loss did not decrease: first '
                             f'three {first:.4f}, last three {last:.4f}')
    expected = {k: v * MB_STEPS for k, v in MB_PER_STEP.items()}
    if launches != expected:
        raise AssertionError(f'MobileNetV1: launches {launches}, expected '
                             f'{expected}')
    # The K3 buckets phase 3 times, in the forms it times them.
    forms = _bucket_forms(kfac, state['inverses'])
    want = {(shape, 'eigen' if max(shape) <= kfac.auto_eigen_max_dim
             else 'baked'): n for shape, n in mobilenet_shapes()['buckets']}
    if forms != want:
        raise AssertionError(f'MobileNetV1: buckets {forms}, expected '
                             f'{want}')
    # The last step's grouped factors: its contribution (stock torch) and
    # the stored EMA against float64 from the same captures.
    decay = kfac.factor_decay
    gaps = {}
    for name in grouped:
        spec = kfac.specs[name]
        a, g = captures[name]['a'][0], captures[name]['g'][0]
        want = _grouped_cov64(spec, a, g)
        got = {'A': L.compute_a_factor(spec, [a]),
               'G': L.compute_g_factor(spec, [g])}
        gaps[name] = {
            'contrib': _max_rel((got[k].double(), want[k]) for k in 'AG'),
            'ema': _max_rel((state['factors'][name][k].double(),
                             decay * prev[name][k].double()
                             + (1 - decay) * want[k]) for k in 'AG')}
    worst = {k: max(v[k] for v in gaps.values()) for k in
             ('contrib', 'ema')}
    log(f'  {MB_GROUPED} grouped layers, last step against float64 '
        f'(F.unfold): contribution {worst["contrib"]:.2e}, EMA '
        f'{worst["ema"]:.2e} (limit {MB_GROUPED_TOL})')
    if max(worst.values()) > MB_GROUPED_TOL:
        raise AssertionError(f'MobileNetV1 grouped factors: {gaps}')
    del captures, grads, precond, prev
    firing = [t for i, t in enumerate(ms) if i % MB_FIRE_EVERY == 0 and i]
    plain = [t for i, t in enumerate(ms) if i % MB_FIRE_EVERY and i]
    summary = {'losses': losses, 'launches': launches, 'step_ms': ms,
               'nonfiring_ms_median': statistics.median(plain),
               'firing_ms': firing, 'step0_ms': ms[0], 'peak_gib': peak,
               'grouped_gaps': gaps, 'grouped_worst': worst,
               'state_bytes': kfac.memory_usage(state)}
    log(f'  loss first three {first:.4f} -> last three {last:.4f}; '
        f'launches {launches}')
    log(f'  ms/step: non-firing {summary["nonfiring_ms_median"]:.2f} '
        f'(median of {len(plain)}), firing {[round(t, 2) for t in firing]} '
        f'(step 0: {ms[0]:.1f}); peak {peak:.2f} GiB above the baseline; '
        f'state {summary["state_bytes"]} bytes ({card})')
    kfac.capture.close()
    del model, kfac, state, opt
    _release()
    summary['nccl_world1'] = _mobilenet_nccl()
    summary['seconds'] = time.perf_counter() - t0
    log(f'  phase 32: {summary["seconds"]:.1f} s wall')
    return summary


def _mobilenet_nccl() -> dict:
    """Phase 32's one-rank NCCL ``DistributedKFAC`` (COMM_OPT): one capture
    per step feeds it and the single-device ``KFAC``, the model stepped
    with the single-device result; every step's factors, preconditioned
    gradients and KL-clip scale held to it (``STEP_TOL``), as phase 13."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch import launch
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    dev = torch.device('cuda')
    store = _fresh_store('nccl_mobilenet.store')
    launch.initialize_distributed(init_method=f'file://{store}', rank=0,
                                  world_size=1, device='cuda')
    try:
        if dist.get_backend() != 'nccl':
            raise AssertionError(f'backend {dist.get_backend()}, not nccl')
        x, y = _fixed_batch(MB_BATCH, MB_PX, dev)
        model = _mobilenet(dev)
        ref = _mobilenet_kfac(model, dev)
        dk = DistributedKFAC(_mobilenet_kfac(model, dev),
                             comm_method='comm-opt')
        if len(dk.assignment.grouped_layers) != MB_GROUPED:
            raise AssertionError(f'grouped layers '
                                 f'{dk.assignment.grouped_layers}')
        ref_state, dk_state = ref.init_state(), dk.init_state()
        errors, failures = [], []
        for step in range(MB_NCCL_STEPS):
            inv = step % MB_FIRE_EVERY == 0
            _, _, grads, captures = ref.capture.loss_and_grads(
                lambda out: F.cross_entropy(out, y), x)
            p_ref, ref_state = ref.step(ref_state, grads, captures,
                                        factor_update=True, inv_update=inv)
            p_dk, dk_state = dk.step(dk_state, grads, captures,
                                     factor_update=True, inv_update=inv)
            err = {'factors': _max_rel(
                       (dk_state['factors'][n][s],
                        ref_state['factors'][n][s])
                       for n in ref.specs for s in 'AG'),
                   'precond': _max_rel((p_dk[n], p_ref[n]) for n in p_ref),
                   'nu': _max_rel([(dk.last_nu, ref.last_nu)])}
            errors.append(err)
            bad = {k: v for k, v in err.items() if not v <= STEP_TOL[k]}
            if bad:
                failures.append(f'step {step}: {bad}')
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p -= MB_LR * p_ref[n]
        ref.capture.close()
        dk.kfac.capture.close()
    finally:
        dist.destroy_process_group()
    worst = {k: max(e[k] for e in errors) for k in STEP_TOL}
    log(f'  shared inputs, {MB_NCCL_STEPS} steps, DistributedKFAC (NCCL, '
        f'world 1, {MB_GROUPED} grouped layers replicated) vs single-device '
        f'KFAC, worst: factors {worst["factors"]:.2e}, preconditioned grads '
        f'{worst["precond"]:.2e}, nu {worst["nu"]:.2e} (limits {STEP_TOL})')
    if failures:
        raise AssertionError(f'MobileNetV1 NCCL world 1: {failures}')
    return {'errors': errors, 'worst': worst}


def _bucket_forms(kfac, inverses: dict) -> dict:
    """``{((G, A) gradient shape, 'eigen' | 'baked'): layers}`` of a K-FAC
    state's dense layers: the K3 buckets a step runs."""
    from distributed_kfac_pytorch_tpu_torch.capture import CONV2D_GROUPED
    params = dict(kfac.model.named_parameters())
    forms: dict = {}
    for name, entry in inverses.items():
        if kfac.specs[name].kind == CONV2D_GROUPED:
            continue
        w = params[f'{name}.weight']
        key = ((w.shape[0], w[0].numel() + int(kfac.specs[name].has_bias)),
               'baked' if 'A_inv' in entry else 'eigen')
        forms[key] = forms.get(key, 0) + 1
    return forms


def _vit_config(**over) -> dict:
    config = {'model': 'vit_small', 'image_size': VIT_PX,
              'batch_size': VIT_BATCH, 'synthetic_size': VIT_BATCH,
              'val_batch_size': VIT_BATCH, 'no_augment': True, 'seed': 0,
              'kfac_update_freq': VIT_FIRE_EVERY, 'kfac_cov_update_freq': 1,
              'damping': 0.003, 'kl_clip': 0.001, 'base_lr': 0.1,
              'warmup_epochs': 0, 'time_steps': True, 'quiet': True}
    config.update(over)
    return config


def _vit_run(label: str, config: dict, per_step: dict, card: str) -> dict:
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.models import vit
    _release()
    kernels.reset_launches()
    res = train_imagenet_resnet.train(config, device='cuda')
    launches = dict(kernels.LAUNCHES)
    state = res.pop('state')
    losses, n = res['losses'], res['steps']
    log(f'  {label}: losses {[round(v, 4) for v in losses]}')
    if n != config['epochs'] or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'{label}: {n} steps, losses {losses}')
    if not isinstance(state.model, vit.VisionTransformer):
        raise AssertionError(f'{label}: model {type(state.model)}')
    k = min(3, n // 2) or 1
    first, last = statistics.mean(losses[:k]), statistics.mean(losses[-k:])
    if not last < first:
        raise AssertionError(f'{label}: loss did not decrease: first {k} '
                             f'{first:.4f}, last {k} {last:.4f}')
    expected = {name: per * n for name, per in per_step.items()}
    if launches != expected:
        raise AssertionError(f'{label}: launches {launches}, expected '
                             f'{expected}')
    # The K3 buckets phase 3 times, in their forms.
    forms = _bucket_forms(state.kfac, state.kfac_state['inverses'])
    want = {(shape, form): count for shape, count, form in VIT_K3_BUCKETS}
    if forms != want:
        raise AssertionError(f'{label}: buckets {forms}, expected {want}')
    firing, plain = _step_ms(res)
    out = {'losses': losses, 'launches': launches, 'fired': res['fired'],
           'approx': state.kfac.approx_summary()['patch_embed'],
           'firing_ms': firing, 'step0_ms': res['step_ms'][0],
           'nonfiring_ms': plain,
           'nonfiring_ms_median': statistics.median(plain)}
    log(f'  {label}: loss first {k} {first:.4f} -> last {k} {last:.4f}; '
        f'launches {launches}; ms/step non-firing '
        f'{out["nonfiring_ms_median"]:.2f} (median of {len(plain)}), firing '
        f'{[round(t, 2) for t in firing]} (step 0: '
        f'{res["step_ms"][0]:.1f}) ({card})')
    return out


def run_vit(card: str) -> dict:
    """Phase 33 (see the module docstring)."""
    t0 = time.perf_counter()
    auto = _vit_run('auto', _vit_config(epochs=VIT_STEPS), VIT_PER_STEP,
                    card)
    if [i for i, f in enumerate(auto['fired']) if f == 'inverse'] != [
            0, VIT_FIRE_EVERY]:
        raise AssertionError(f'ViT: fired {auto["fired"]}')
    reduce = _vit_run('reduce', _vit_config(epochs=VIT_REDUCE_STEPS,
                                            kfac_approx='reduce'),
                      VIT_REDUCE_PER_STEP, card)
    if reduce['approx'] != 'reduce':
        raise AssertionError(f'ViT reduce: patch conv {reduce["approx"]}')
    launches: dict = {}
    for run in (auto, reduce):
        _add(launches, run['launches'])
    seconds = time.perf_counter() - t0
    log(f'  phase 33: {seconds:.1f} s wall')
    return {'auto': auto, 'reduce': reduce, 'launches': launches,
            'seconds': seconds}


def run_model_phases(card: str) -> dict:
    """Phases 32 and 33."""
    log(f'== MobileNetV1 (13 depthwise convs, conv2d_grouped), width 1.0, '
        f'{MB_PX} px, batch {MB_BATCH}, damping {MB_DAMPING}, lr {MB_LR}, '
        f'inverses every {MB_FIRE_EVERY}, {MB_STEPS} KFAC.step steps on one '
        f'batch; then {MB_NCCL_STEPS} shared-input steps in a one-rank NCCL '
        'group')
    out = {'mobilenet': run_mobilenet(card)}
    log(f'== ViT-S/16 through the ImageNet CLI, {VIT_PX} px, batch '
        f'{VIT_BATCH}, auto, {VIT_STEPS} steps on one batch; then '
        f'{VIT_REDUCE_STEPS} steps under --kfac-approx reduce')
    out['vit'] = run_vit(card)
    return out


# ---------------------------------------------------------------------------
# fp16 compute, the dynamic loss scale and bf16 activations (phases 3's fp16
# cases and 34-36)
# ---------------------------------------------------------------------------

#: Phase 3's ResNet-50 ``--fp16`` model, batch and loss scale, kept for
#: phase 34's guard check (``'inputs'``).
_R50_FP16_SHARED: dict = {}


def _step_inputs_r50_fp16(dev):
    """ResNet-50 at fp16 compute (seed 0), its ``KFAC`` and one capture
    pass over phase 6's fixed batch under the loss scale the ``--fp16``
    step would train at: 2**15, halved while the pass overflows, as the
    dynamic scale backs off. Returns ``(model, kfac, x, y, captures,
    scale)``."""
    import torch
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch import fp16
    from distributed_kfac_pytorch_tpu_torch.models import imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    x, y = _fixed_batch(R50_BATCH, 224, dev)
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(0)
        model = imagenet_resnet.get_model(
            'resnet50', dtype=torch.float16).to(dev)
    kfac = KFAC(model, device=dev)
    scale = FP16_INIT_SCALE
    while True:
        _, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, y), x,
            loss_scale=torch.tensor(scale, device=dev))
        if bool(fp16.tree_all_finite([grads, captures])):
            return model, kfac, x, y, captures, scale
        if scale <= 1.0:
            raise AssertionError('fp16 R-50: the pass overflows at scale 1')
        scale /= 2


def check_fp16_inputs(card: str) -> dict:
    """Phase 3's fp16 cases: K1 and K2 over the whole ResNet-50 ``--fp16``
    step's launch set on the step's own captures (fp16 activations into K2
    after the stem and into the fc's K1 A side; fp32 unscaled output-grads
    into K1's G sides), each held against its plain version on the same
    inputs at the fp32 tolerance and, where its input is fp16, bit for bit
    against the same launch on the input widened first (the widening is
    exact); the step's set timed on these inputs and on the same inputs
    widened beforehand, beside the plain versions and the library
    yardsticks, with the bound of the fp16-input work."""
    import torch
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch.capture import CONV2D
    from distributed_kfac_pytorch_tpu_torch.ops import kernels as K
    dev = torch.device('cuda')
    _release()
    model, kfac, x, y, caps, loss_scale = _step_inputs_r50_fp16(dev)
    log(f'  the step\'s captures at loss scale {loss_scale:g}')
    kfac.observe_specs()
    k1, k2 = [], []
    for name, spec in kfac.specs.items():
        entry = caps[name]
        for side, (t, scale, bias) in kfac.fused_factor_inputs(
                spec, entry).items():
            k1.append((f'{name} {side}', t, scale, bias))
        if spec.kind == CONV2D:
            k2.append((name, entry['a'][0], spec))
    del caps
    counts = {'factor_ema': len(k1), 'patch_cov': len(k2)}
    if counts != {k: R50_PER_STEP[k] for k in counts}:
        raise AssertionError(f'fp16 R-50 step: {counts} K1/K2 launches, '
                             f'expected {R50_PER_STEP}')
    calls = {
        'factor_ema': [(label, t, (
            lambda t, s=scale, b=bias: K.factor_ema(
                t, None, 0.0, scale=s, has_bias=b)), (
            lambda t, s=scale, b=bias: K.factor_ema_plain(
                t, None, 0.0, scale=s, has_bias=b)))
            for label, t, scale, bias in k1],
        'patch_cov': [(name, a, (
            lambda t, sp=spec: K.patch_cov(t, sp.kernel_size, sp.strides,
                                           sp.padding, sp.has_bias)), (
            lambda t, sp=spec: K.patch_cov_plain(
                t, sp.kernel_size, sp.strides, sp.padding, sp.has_bias)))
            for name, a, spec in k2]}
    out = {}
    for kname, cases in calls.items():
        dtypes: dict = {}
        worst = max_abs = 0.0
        t_bytes = t_ops = 0.0
        for label, t, kern, plain in cases:
            dtypes[str(t.dtype)] = dtypes.get(str(t.dtype), 0) + 1
            got = kern(t)
            abs_err, rel = rel_err(got, plain(t))
            if not rel <= TOL_FP32[kname]:
                raise AssertionError(f'{kname} fp16 step {label}: rel err '
                                     f'{rel:.3g} > {TOL_FP32[kname]}')
            if t.dtype == torch.float16 and not torch.equal(
                    got, kern(t.float())):
                raise AssertionError(f'{kname} fp16 step {label}: differs '
                                     'from the launch on the widened input')
            worst, max_abs = max(worst, rel), max(max_abs, abs_err)
            if kname == 'factor_ema':
                rows, d = K._gram_rows(t).shape
            else:
                sp = dict((c[0], c[2]) for c in k2)[label]
                _, oh, ow = K.conv_out_geometry(t.shape, sp.kernel_size,
                                                sp.strides, sp.padding)
                rows = t.shape[0] * oh * ow
                d = t.shape[1] * sp.kernel_size[0] * sp.kernel_size[1]
            n = d + int(got.shape[-1] > d)
            t_bytes += (t.numel() * t.element_size() + 4 * n * n) \
                / PEAK_BYTES * 1e3
            t_ops += rows * d * (d + 1) / OPS_PEAK[kname] * 1e3
        wide = [(c[1].float(), c[2]) for c in cases]

        def library(cases=cases, kname=kname):
            for label, t, _, _ in cases:
                if kname == 'factor_ema':
                    r = K._gram_rows(t).float()
                else:
                    sp = dict((c[0], c[2]) for c in k2)[label]
                    (ph, _), (pw, _) = K.conv_out_geometry(
                        t.shape, sp.kernel_size, sp.strides, sp.padding)[0]
                    r = F.unfold(t.float(), sp.kernel_size, padding=(ph, pw),
                                 stride=sp.strides).transpose(1, 2).reshape(
                        -1, t.shape[1] * sp.kernel_size[0]
                        * sp.kernel_size[1])
                r.T @ r

        row = {
            'launches': len(cases), 'input_dtypes': dtypes,
            'max_abs_err': max_abs, 'max_rel_err': worst,
            'ms': time_ms(lambda: [c[2](c[1]) for c in cases], 3, 3, 1),
            'fp32_input_ms': time_ms(lambda: [k(t) for t, k in wide],
                                     3, 3, 1),
            'plain_ms': time_ms(lambda: [c[3](c[1]) for c in cases],
                                1, 3, 1),
            'library_ms': time_ms(library, 1, 3, 1),
            'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}
        out[kname] = row
        log(f'  {kname:11s} fp16 R-50 step: {row["launches"]} launches, '
            f'inputs {dtypes}, max rel err {worst:.2e}; ms '
            f'{row["ms"]:.3f} (inputs widened first {row["fp32_input_ms"]:.3f})'
            f' plain {row["plain_ms"]:.3f} lib {row["library_ms"]:.3f} bound '
            f'{row["bound_ms"]:.3f} ({row["bound_by"]}) ({card})')
        del wide
    kfac.capture.close()
    _R50_FP16_SHARED['inputs'] = (model, x, y, loss_scale)
    del model, kfac, calls, k1, k2
    _release()
    return out


def _state_tensors(state) -> dict:
    """Clones of what an overflow-skipped step must leave as it was: the
    parameters, the SGD momentum, every ``kfac_state`` tensor and the
    model's buffers."""
    import torch

    def flat(tree, out):
        if isinstance(tree, torch.Tensor):
            out.append(tree.detach().clone())
        elif isinstance(tree, dict):
            for k in sorted(tree, key=str):
                flat(tree[k], out)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                flat(v, out)
        return out

    return {'params': flat(list(state.model.parameters()), []),
            'momentum': flat([s.get('momentum_buffer') for s in
                              state.optimizer.state.values()], []),
            'kfac_state': flat({k: v for k, v in state.kfac_state.items()
                                if k != 'step'}, []),
            'buffers': flat(list(state.model.buffers()), []),
            'kfac_step': state.kfac_state['step']}


def _scaler_log(res) -> str:
    return ', '.join(f'{r["scale"]:g}{"!" if r["overflow"] else ""}'
                     for r in res['scaler'])


def _fp16_launch_plan(res, per_step: dict) -> dict:
    """The launches of a run that skipped its overflow steps: the per-step
    plan times the steps that ran their K-FAC step."""
    ran = sum(not r['overflow'] for r in res['scaler'])
    plan = {k: v * ran for k, v in per_step.items()}
    plan.setdefault('ns_inverse', 0)
    plan.setdefault('jacobi_eigh', 0)
    return plan


def run_resnet50_fp16(card: str, r50: dict | None,
                      r50_auto: dict | None) -> dict:
    """Phase 34 (see the module docstring)."""
    import os

    import torch
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine
    t0 = time.perf_counter()
    _release()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = train_imagenet_resnet.train(
        _r50_config(epochs=FP16_STEPS, fp16=True), device='cuda')
    launches = dict(kernels.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    state = res.pop('state')
    losses, n = res['losses'], res['steps']
    log(f'  losses: {[round(v, 4) for v in losses]}')
    log(f'  loss scale per step (! = overflow, skipped): {_scaler_log(res)}')
    if n != FP16_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'fp16 R-50: {n} steps, losses {losses}')
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'fp16 R-50: loss did not decrease: first '
                             f'three {first:.4f}, last three {last:.4f}')
    if [i for i, f in enumerate(res['fired']) if f == 'inverse'] != [
            0, R50_FIRE_EVERY]:
        raise AssertionError(f'fp16 R-50: fired {res["fired"]}')
    expected = _fp16_launch_plan(res, R50_PER_STEP)
    if launches != expected:
        raise AssertionError(f'fp16 R-50: launches {launches}, expected '
                             f'{expected}')
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError('fp16 R-50: a parameter is not fp32')
    firing, plain = _step_ms(res)
    clean_over = [r['overflow'] for r in res['scaler']]
    summary = {'losses': losses, 'scaler': res['scaler'],
               'loss_first3': first, 'loss_last3': last,
               'launches': launches, 'firing_ms': firing,
               'step0_ms': res['step_ms'][0], 'nonfiring_ms': plain,
               'nonfiring_ms_median': statistics.median(plain),
               'peak_gib': peak}
    log(f'  loss first three {first:.4f} -> last three {last:.4f}; launches '
        f'{launches}')
    ref6 = (f'{r50["nonfiring_ms_median"]:.2f} / {r50["firing_ms"]}'
            if r50 else 'not run')
    ref7 = (f'{statistics.median(r50_auto["nonfiring_ms"]):.2f}, peak '
            f'{r50_auto["peak_gib"]:.2f} GiB' if r50_auto else 'not run')
    log(f'  ms/step: non-firing {summary["nonfiring_ms_median"]:.2f} (median '
        f'of {len(plain)}), firing {[round(t, 1) for t in firing]} (step 0: '
        f'{res["step_ms"][0]:.1f}); peak {peak:.2f} GiB above the baseline; '
        f'fp32 phase 6 (newton) non-firing / firing {ref6}, phase 7 (auto) '
        f'non-firing {ref7} ({card})')
    del state, res
    _release()

    # The same run with the nan-batch fault: step FP16_CHAOS_STEP skipped.
    snaps: dict = {}
    real = engine.train_step

    def watched(state, x, y, hyper, flags, *args, **kw):
        if state.step == FP16_CHAOS_STEP:
            snaps['before'] = _state_tensors(state)
        out = real(state, x, y, hyper, flags, *args, **kw)
        if state.step == FP16_CHAOS_STEP:
            snaps['after'] = _state_tensors(state)
        return out

    engine.train_step = watched
    os.environ['KFAC_CHAOS'] = f'nan-batch@{FP16_CHAOS_STEP}'
    try:
        kernels.reset_launches()
        res = train_imagenet_resnet.train(
            _r50_config(epochs=FP16_CHAOS_STEPS, fp16=True), device='cuda')
    finally:
        engine.train_step = real
        del os.environ['KFAC_CHAOS']
    launches = dict(kernels.LAUNCHES)
    res.pop('state')
    losses, scaler = res['losses'], res['scaler']
    log(f'  KFAC_CHAOS=nan-batch@{FP16_CHAOS_STEP}: losses '
        f'{[round(v, 4) for v in losses]}; scale {_scaler_log(res)}')
    # The poisoned step overflows, and only the steps the clean run's
    # scale schedule skipped besides it.
    over = [r['overflow'] for r in scaler]
    want = [o or i == FP16_CHAOS_STEP
            for i, o in enumerate(clean_over[:FP16_CHAOS_STEPS])]
    if over != want:
        raise AssertionError(f'nan-batch: overflow steps {over}, expected '
                             f'{want}')
    if scaler[FP16_CHAOS_STEP + 1]['scale'] != \
            scaler[FP16_CHAOS_STEP]['scale'] / 2:
        raise AssertionError(f'nan-batch: the scale did not halve: {scaler}')
    if not all(math.isfinite(v) for i, v in enumerate(losses)
               if i != FP16_CHAOS_STEP):
        raise AssertionError(f'nan-batch: losses {losses}')
    before, after = snaps['before'], snaps['after']
    held = {}
    for key in ('params', 'momentum', 'kfac_state', 'buffers'):
        same = sum(torch.equal(a, b) for a, b in zip(before[key],
                                                     after[key]))
        held[key] = f'{same}/{len(before[key])}'
        if same != len(before[key]) or not before[key]:
            raise AssertionError(f'nan-batch: {key} moved at the skipped '
                                 f'step ({held[key]} tensors equal)')
    if after['kfac_step'] != before['kfac_step'] + 1:
        raise AssertionError('nan-batch: kfac_state step did not advance')
    expected = _fp16_launch_plan(res, R50_PER_STEP)
    if launches != expected:
        raise AssertionError(f'nan-batch: launches {launches}, expected '
                             f'{expected}')
    log(f'  step {FP16_CHAOS_STEP} skipped: bit for bit before / after '
        f'(tensors equal) {held}; kfac_state step '
        f'{before["kfac_step"]} -> {after["kfac_step"]}; launches '
        f'{launches}')
    summary['chaos'] = {'losses': losses, 'scaler': scaler, 'held': held,
                        'launches': launches}
    _add(summary['launches'], launches)
    del snaps, before, after, res
    _release()

    # KFAC(nonfinite_guard=True) on a poisoned capture, directly, on phase
    # 3's model, batch and scale.
    dev = torch.device('cuda')
    model, x, y, scale = _R50_FP16_SHARED.pop('inputs')
    scale = torch.tensor(scale, device=dev)
    bad = x.clone()
    bad[0, 0, 0, 0] = float('nan')
    guard = {}
    for guarded in (True, False):
        kf = KFAC(model, device=dev, nonfinite_guard=guarded)
        _, _, grads, caps = kf.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, y), x, loss_scale=scale)
        _, st = kf.step(kf.init_state(), grads, caps, factor_update=True,
                        inv_update=False)
        _, _, grads, caps = kf.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, y), bad, loss_scale=scale)
        _, st2 = kf.step(st, grads, caps, factor_update=True,
                         inv_update=False)
        pairs = [(st['factors'][n][s], st2['factors'][n][s])
                 for n in st['factors'] for s in 'AG']
        guard[guarded] = {
            'equal': sum(torch.equal(a, b) for a, b in pairs),
            'finite': sum(bool(torch.isfinite(b).all()) for _, b in pairs),
            'factors': len(pairs)}
        kf.capture.close()
        del kf, st, st2, grads, caps, pairs
    log(f'  nonfinite_guard on a poisoned capture: guarded {guard[True]}, '
        f'unguarded {guard[False]}')
    if guard[True]['equal'] != guard[True]['factors'] or \
            guard[False]['finite'] == guard[False]['factors']:
        raise AssertionError(f'nonfinite_guard: {guard}')
    summary['guard'] = {str(k): v for k, v in guard.items()}
    del model, x, y, bad
    _release()
    summary['seconds'] = time.perf_counter() - t0
    log(f'  phase 34: {summary["seconds"]:.1f} s wall')
    return summary


def run_transformer_xl_fp16(card: str, xl: dict | None) -> dict:
    """Phase 35 (see the module docstring)."""
    import torch
    from distributed_kfac_pytorch_tpu_torch import train_language_model
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    _release()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = train_language_model.train(
        _xl_config(nlayers=FP16_XL_LAYERS, max_steps=FP16_XL_STEPS,
                   fp16=True), device='cuda')
    launches = dict(kernels.LAUNCHES)
    state = res.pop('state')
    losses, n = res['losses'], res['steps']
    log(f'  losses: {[round(v, 4) for v in losses]}; scale '
        f'{_scaler_log(res)}')
    if n != FP16_XL_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'fp16 XL: {n} steps, losses {losses}')
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'fp16 XL: loss did not decrease: first three '
                             f'{first:.4f}, last three {last:.4f}')
    if res['fired'].count('inverse') != 1:
        raise AssertionError(f'fp16 XL: fired {res["fired"]}')
    # Phase 15's plan at FP16_XL_LAYERS blocks: K1 on the 6 Linears' two
    # sides per block and the embedding's G, K3 on the three buckets.
    expected = _fp16_launch_plan(res, {
        **XL_PER_STEP, 'factor_ema': 12 * FP16_XL_LAYERS + 1})
    if launches != expected:
        raise AssertionError(f'fp16 XL: launches {launches}, expected '
                             f'{expected}')
    plain = res['step_ms'][1:]
    summary = {'layers': FP16_XL_LAYERS, 'losses': losses,
               'scaler': res['scaler'], 'launches': launches,
               'step0_ms': res['step_ms'][0], 'nonfiring_ms': plain,
               'nonfiring_ms_median': statistics.median(plain),
               'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30}
    ref = (f'{xl["nonfiring_ms_median"]:.2f} ms, peak {xl["peak_gib"]:.1f} '
           'GiB' if xl else 'not run')
    log(f'  loss first three {first:.4f} -> last three {last:.4f}; launches '
        f'{launches}')
    log(f'  ms/step: non-firing {summary["nonfiring_ms_median"]:.2f} (median '
        f'of {len(plain)}), firing step 0 {res["step_ms"][0]:.1f}; peak '
        f'{summary["peak_gib"]:.1f} GiB; fp32 phase 15 non-firing {ref} '
        f'({card})')
    del state, res
    _release()
    summary['seconds'] = time.perf_counter() - t0
    log(f'  phase 35: {summary["seconds"]:.1f} s wall')
    return summary


def _bf16_model_run(label: str, model, x, y, kfac_kw: dict,
                    per_step: dict, ref: dict | None, card: str) -> dict:
    """``BF16_MODEL_STEPS`` ``engine.train_step`` calls on one batch (SGD
    lr 0.1, momentum 0.9; factors every step, inverses every 10): finite,
    falling losses, the per-step launch plan, step ms and peak memory
    beside the fp32 phase's ``ref``."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine
    dev = x.device
    kfac = KFAC(model, factor_update_freq=1, inv_update_freq=10,
                device=dev, **kfac_kw)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    state = engine.TrainState(model=model, optimizer=opt, kfac=kfac,
                              kfac_state=kfac.init_state())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, ms = [], []
    for step in range(BF16_MODEL_STEPS):
        flags = engine.cadence_flags(step, 1, 10)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = engine.train_step(state, x, y, {'lr': 0.1}, flags)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        state.step += 1
    launches = dict(kernels.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f'  {label}: losses {[round(v, 4) for v in losses]}')
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'{label}: losses {losses}')
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'{label}: loss did not decrease: first three '
                             f'{first:.4f}, last three {last:.4f}')
    expected = {k: v * BF16_MODEL_STEPS for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f'{label}: launches {launches}, expected '
                             f'{expected}')
    out = {'losses': losses, 'launches': launches, 'step_ms': ms,
           'nonfiring_ms_median': statistics.median(ms[1:]),
           'step0_ms': ms[0], 'peak_gib': peak}
    fp32 = (f'{ref["nonfiring_ms_median"]:.2f} ms'
            + (f', peak {ref["peak_gib"]:.2f} GiB' if 'peak_gib' in ref
               else '') if ref else 'not run')
    log(f'  {label}: loss first three {first:.4f} -> last three {last:.4f}; '
        f'launches {launches}; ms/step non-firing '
        f'{out["nonfiring_ms_median"]:.2f} (median of {len(ms) - 1}), firing '
        f'step 0 {ms[0]:.1f}; peak {peak:.2f} GiB; fp32 {fp32} ({card})')
    kfac.capture.close()
    return out


def run_bf16_models(card: str, mb: dict | None, vit_ref: dict | None
                    ) -> dict:
    """Phase 36 (see the module docstring)."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.models import mobilenet, vit
    t0 = time.perf_counter()
    dev = torch.device('cuda')
    out = {}
    for key, label, build, px, batch, per_step, ref in (
            ('mobilenet', 'MobileNetV1 bf16', lambda: mobilenet.get_model(
                1000, dtype=torch.bfloat16), MB_PX, MB_BATCH, MB_PER_STEP,
             mb),
            ('vit', 'ViT-S/16 bf16', lambda: vit.get_model(
                1000, 'small', image_size=VIT_PX, dtype=torch.bfloat16),
             VIT_PX, VIT_BATCH, VIT_PER_STEP, vit_ref)):
        _release()
        x, y = _fixed_batch(batch, px, dev)
        with torch.random.fork_rng(devices=[dev]):
            torch.manual_seed(0)
            model = build().to(dev)
        kw = {'damping': MB_DAMPING, 'lr': MB_LR, 'kl_clip': 0.001}
        out[key] = _bf16_model_run(label, model, x, y, kw, per_step, ref,
                                   card)
        del model, x, y
    _release()
    out['launches'] = {}
    for key in ('mobilenet', 'vit'):
        _add(out['launches'], out[key]['launches'])
    out['seconds'] = time.perf_counter() - t0
    log(f'  phase 36: {out["seconds"]:.1f} s wall')
    return out


#: The half-precision paths ``--profile`` adds, each beside its fp32 twin
#: (``profile_main_path``).
PROFILE_HALF = ('resnet50_fp16', 'vit_small', 'vit_small_bf16',
                'transformer_xl_fp16')


def run_fp16_phases(card: str, refs: dict) -> dict:
    """Phases 34-36; ``refs`` holds the fp32 phases' summaries they print
    beside theirs (None in ``--fp16-only``)."""
    log(f'== ResNet-50 --fp16 through the ImageNet CLI, 224 px, batch '
        f'{R50_BATCH}, auto, {FP16_STEPS} steps on one batch; then '
        f'KFAC_CHAOS=nan-batch@{FP16_CHAOS_STEP} over {FP16_CHAOS_STEPS} '
        'steps; then KFAC(nonfinite_guard=True) on a poisoned capture')
    out = {'resnet50_fp16': run_resnet50_fp16(
        card, refs.get('resnet50_newton'), refs.get('resnet50_auto'))}
    log(f'== Transformer-XL LM --fp16 (d {XL_D}, {FP16_XL_LAYERS} blocks, '
        f'vocabulary {XL_VOCAB}, tied), BPTT {XL_BPTT}, batch {XL_BATCH}, '
        f'auto, {FP16_XL_STEPS} steps, one firing')
    out['transformer_xl_fp16'] = run_transformer_xl_fp16(
        card, refs.get('transformer_xl'))
    log(f'== bf16 activations: MobileNetV1 ({MB_PX} px) and ViT-S/16 '
        f'({VIT_PX} px) at torch.bfloat16, batch {MB_BATCH}, '
        f'{BF16_MODEL_STEPS} steps each')
    out['bf16_models'] = run_bf16_models(
        card, refs.get('mobilenet'), (refs.get('vit') or {}).get('auto'))
    return out


# ---------------------------------------------------------------------------
# Phases 37-39: the randomized low-rank inverse and the multi-slice world
# ---------------------------------------------------------------------------

# Phase 37: phase 15's XL run under --inv-lowrank-rank 256 at the default
# threshold 2048: mlp_in's G (4096) and mlp_out's A (4097) take rank-256
# truncated eigenpairs. Under 'auto' both layers are mixed (the other side
# a Cholesky inverse), bake the truncated side, and keep K3's baked path:
# the launches are phase 15's. Then LOWRANK_XL_EIGEN_STEPS steps under
# --inverse-method eigen, where the two truncated buckets run the stock
# precondition and K3 runs the (1024, 1025) eigen bucket alone. One engaged
# factor's next decomposition, on the card and on the CPU from the same
# factor and carried basis: the damped operators within
# LOWRANK_OPERATOR_TOL of the CPU's largest entry.
LOWRANK_RANK, LOWRANK_THRESHOLD = 256, 2048
LOWRANK_XL_EIGEN_STEPS = 6
LOWRANK_OPERATOR_TOL = 1e-4
# Phase 39: 4 gloo ranks as 2 slices x 2 at ResNet-32 width, inverses every
# 2 (window heads at steps 0, 2, 4). The hierarchical reduce against the
# flat one on the same layout (COMM_OPT: a slice is one row of two ranks):
# two DistributedKFACs on one model, both fed each step's captures of the
# same weights, which follow the flat run (the trajectory is shared, so
# the two differ only by their reductions); then a low-rank case on 2
# slices (HYBRID_OPT 0.5: four global rows of one rank) at threshold 512,
# rank 32, so that the 576-wide stage-3 A sides (64 x 3 x 3, no bias)
# engage, held against the single-device KFAC on the full batch.
SLICE_GLOO_CASES = (  # (name, comm_method, fraction, knobs, grid)
    ('flat', 'comm-opt', 0.0, {}, (2, 2)),
    ('hierarchical', 'comm-opt', 0.0, {'hierarchical_reduce': True},
     (2, 2)),
    ('lowrank', 'hybrid-opt', 0.5,
     {'inv_lowrank_rank': 32, 'inv_lowrank_dim_threshold': 512}, (4, 1)))
SLICE_STEPS, SLICE_INV_FREQ, SLICE_COUNT = 5, 2, 2
# The low-rank case against the single-device KFAC: the warm subspace step
# carries the fp32 summation-order noise of the factors into the
# preconditioned gradients (tests/test_torch_lowrank_dist.py: up to 7e-4
# by relative norm on the CPU), so each layer is held by relative norm.
SLICE_LOWRANK_TOL = {'factors': 1e-5, 'precond_norm': 5e-3, 'nu': 1e-3}


def _operator_check(factor, basis, damping: float) -> dict:
    """One engaged factor's next low-rank decomposition from its carried
    basis, on the card and on the CPU (``linalg.lowrank_eigh``), each
    turned into the damped operator ``I/l + Q diag(1/(d + l) - 1/l)
    Q^T``; their largest difference over the CPU's largest entry, and the
    card's time for the call."""
    import torch
    from distributed_kfac_pytorch_tpu_torch.ops import linalg
    f = factor.float()
    q = basis.float()

    def operator(dev):
        qs, ds = linalg.lowrank_eigh(f.to(dev), q.shape[-1],
                                     q_prev=q.to(dev))
        return linalg.eigen_side_inverse(qs, ds, damping).double().cpu()

    gpu = operator('cuda')
    cpu = operator('cpu')
    err = float((gpu - cpu).abs().max() / cpu.abs().max())
    ms = time_ms(lambda: linalg.lowrank_eigh(f, q.shape[-1], q_prev=q),
                 reps=3, trials=3, warmup=1)
    return {'rel_err': err, 'lowrank_eigh_ms': ms, 'dim': f.shape[-1],
            'rank': q.shape[-1]}


LOWRANK_XL = {'inv_lowrank_rank': LOWRANK_RANK,
              'inv_lowrank_dim_threshold': LOWRANK_THRESHOLD}


def run_transformer_xl_lowrank(card: str, xl: dict | None) -> dict:
    """Phase 37: the XL LM CLI with ``--inv-lowrank-rank 256``, 12 steps
    under ``auto`` (firings at steps 0 and 10; phase 15's launches, every
    bucket baked) and the operator check on block 0's mlp_in G. Its
    ``--inverse-method eigen`` run is :func:`run_transformer_xl_lowrank_
    eigen`."""
    res, launches, state = _run_tlm('transformer-xl low-rank',
                                    _xl_config(**LOWRANK_XL), XL_PER_STEP, 2)
    kfac, kst = state.kfac, state.kfac_state
    d = XL_D
    inv = kst['inverses']
    shapes = {'mlp_in QG': tuple(inv['block0.mlp_in']['QG'].shape),
              'mlp_out QA': tuple(inv['block0.mlp_out']['QA'].shape)}
    want = {'mlp_in QG': (4 * d, LOWRANK_RANK),
            'mlp_out QA': (4 * d + 1, LOWRANK_RANK)}
    baked = all(k in inv['block0.mlp_in'] for k in ('G_inv', 'A_inv'))
    if shapes != want or not baked \
            or kfac.method_for_dim(4 * d) != 'lowrank' \
            or kfac.method_for_dim(d + 1) != 'cholesky':
        raise AssertionError(f'xl low-rank: bases {shapes}, mixed layer '
                             f'baked {baked}')
    check = _operator_check(kst['factors']['block0.mlp_in']['G'],
                            inv['block0.mlp_in']['QG'], kfac.damping)
    if not check['rel_err'] <= LOWRANK_OPERATOR_TOL:
        raise AssertionError(f'xl low-rank: the card\'s damped operator '
                             f'{check["rel_err"]:.2e} off the CPU\'s')
    inverse_bytes = sum(t.numel() * t.element_size()
                        for e in inv.values() for t in e.values())
    del state, kfac, kst, inv
    _release()
    firing, plain = _step_ms(res)
    summary = {'losses': res['losses'], 'launches': launches,
               'step_ms': res['step_ms'], 'firing_ms': firing,
               'nonfiring_ms_median': statistics.median(plain),
               'peak_gib': res['peak_gib'], 'inverse_bytes': inverse_bytes,
               'operator': check}
    ref = xl or {}
    log(f'  low-rank {LOWRANK_RANK}, auto: ms/step non-firing '
        f'{summary["nonfiring_ms_median"]:.2f} (phase 15 '
        f'{ref.get("nonfiring_ms_median", float("nan")):.2f}), step-10 '
        f'firing {firing[0]:.1f} (phase 15 '
        f'{(ref.get("firing_ms") or [float("nan")])[0]:.1f}); peak '
        f'{res["peak_gib"]:.2f} GiB (phase 15 '
        f'{ref.get("peak_gib", float("nan")):.2f}); inverses '
        f'{inverse_bytes / 1e9:.3f} GB (phase 15 '
        f'{ref.get("inverse_bytes", float("nan")) / 1e9:.3f}) ({card})')
    log(f'  block0.mlp_in G ({check["dim"]}, rank {check["rank"]}): the '
        f'next firing\'s damped operator on the card vs the CPU '
        f'{check["rel_err"]:.2e} (limit {LOWRANK_OPERATOR_TOL:.0e}); '
        f'lowrank_eigh {check["lowrank_eigh_ms"]:.2f} ms on the card')
    return summary


def run_transformer_xl_lowrank_eigen(card: str) -> dict:
    """Phase 37, its second run: LOWRANK_XL_EIGEN_STEPS steps of the XL
    LM CLI with ``--inv-lowrank-rank 256 --inverse-method eigen``, one
    firing: K3 on the one full-rank eigen bucket per step, the two
    truncated buckets by stock torch, mlp_in's slots an unmixed eigenpair
    with the (4096, 256) basis. In the full script it runs beside phase
    14's worlds (subprocesses: the launch counts stay its own), so its
    step ms are those of a shared host."""
    d = XL_D
    res, launches, state = _run_tlm(
        'transformer-xl low-rank eigen',
        _xl_config(inverse_method='eigen',
                   max_steps=LOWRANK_XL_EIGEN_STEPS, **LOWRANK_XL),
        {**XL_PER_STEP, 'bucket_precond': 1}, 1)
    entry = state.kfac_state['inverses']['block0.mlp_in']
    slots = {k: tuple(t.shape) for k, t in entry.items()}
    if set(slots) != {'QA', 'dA', 'QG', 'dG'} \
            or slots['QG'] != (4 * d, LOWRANK_RANK):
        raise AssertionError(f'xl low-rank eigen: mlp_in slots {slots}')
    del state, entry
    _release()
    plain = res['step_ms'][1:]
    summary = {'losses': res['losses'], 'launches': launches,
               'step_ms': res['step_ms'],
               'nonfiring_ms_median': statistics.median(plain),
               'peak_gib': res['peak_gib']}
    log(f'  phase 37, low-rank {LOWRANK_RANK} under eigen, '
        f'{LOWRANK_XL_EIGEN_STEPS} steps: ms/step non-firing '
        f'{summary["nonfiring_ms_median"]:.2f} (median of {len(plain)}; K3 '
        f'on the ({d}, {d + 1}) bucket, the two truncated buckets by stock '
        f'torch), step 0 {res["step_ms"][0]:.1f}; peak '
        f'{res["peak_gib"]:.2f} GiB ({card})')
    return summary


def run_resnet152_lowrank(card: str, r152: dict, c5: dict | None) -> dict:
    """Phase 38: phase 23's config 5 (ResNet-152, 224 px, batch 64,
    ``--bf16-factors``, ``eigen``) with ``--inv-lowrank-rank 256``, 12
    steps: the shape buckets with a side of 2048 or more precondition by
    stock torch, the others through K3; losses finite and falling; the
    step-10 firing, the window mean (steps 1-10: nine plain steps and the
    firing) and the inverse-state bytes beside phase 23's."""
    k3 = sum(1 for (g, a), _ in r152['buckets']
             if g < LOWRANK_THRESHOLD and a < LOWRANK_THRESHOLD)

    def inspect(state):
        kfac = state.kfac
        engaged = sorted({int(t.shape[-2]) for e in
                          state.kfac_state['inverses'].values()
                          for k, t in e.items() if k.startswith('Q')
                          and t.shape[-1] == LOWRANK_RANK
                          and t.shape[-2] != LOWRANK_RANK})
        if engaged != sorted(d for d in engaged
                             if kfac.method_for_dim(d) == 'lowrank') \
                or not engaged:
            raise AssertionError(f'config 5 low-rank: engaged dims {engaged}')
        return {'engaged_dims': engaged}

    run = _r152_run(f'low-rank {LOWRANK_RANK}', card, R152_STEPS, k3,
                    inspect=inspect,
                    bf16_factors=True, inv_lowrank_rank=LOWRANK_RANK,
                    inv_lowrank_dim_threshold=LOWRANK_THRESHOLD)
    losses = run['losses']
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f'config 5 low-rank: loss did not decrease: '
                             f'first three {first:.4f}, last three '
                             f'{last:.4f}')
    window = statistics.mean(run['step_ms'][1:R50_FIRE_EVERY + 1])
    run.update(k3_buckets=k3, stock_buckets=len(r152['buckets']) - k3,
               window_mean_ms=window)
    exact = (c5 or {}).get('bf16_factors') or {}
    exact_window = (statistics.mean(exact['step_ms'][1:R50_FIRE_EVERY + 1])
                    if exact else float('nan'))
    run['exact'] = {'firing_ms': exact.get('firing_ms'),
                    'window_mean_ms': exact_window,
                    'inverse_bytes': exact.get('inverse_bytes'),
                    'nonfiring_ms_median': exact.get('nonfiring_ms_median')}
    log(f'  config 5 low-rank {LOWRANK_RANK} (engaged dims '
        f'{run["engaged_dims"]}; K3 '
        f'on {k3} buckets, {run["stock_buckets"]} by stock torch): step-10 '
        f'firing {run["firing_ms"][0]:.1f} ms (phase 23 '
        f'{(exact.get("firing_ms") or [float("nan")])[0]:.1f}), window '
        f'mean {window:.2f} (phase 23 {exact_window:.2f}), non-firing '
        f'{run["nonfiring_ms_median"]:.2f} (phase 23 '
        f'{exact.get("nonfiring_ms_median", float("nan")):.2f}); inverses '
        f'{run["inverse_bytes"] / 1e9:.3f} GB (phase 23 '
        f'{exact.get("inverse_bytes", float("nan")) / 1e9:.3f}) ({card})')
    return run


def slice_dist_worker(cfg: dict) -> int:
    """One rank of phase 39 (``chip_smoke.py --dist-worker CONFIG``, phase
    ``'resnet32_slices'``): ResNet-32 as phase 14 runs it, as slice
    ``rank // 2`` of two. First the flat and the hierarchical
    ``DistributedKFAC`` side by side on one model, each step's captures
    taken for both from the same weights, the weights stepped with the
    flat run's gradients: the hierarchical factors at every window head,
    every step's gradients and ``nu`` held to the flat run's at STEP_TOL.
    Then the low-rank case, rank 0 holding it against the single-device
    ``KFAC`` on the full batch (SLICE_LOWRANK_TOL). Each run's launches,
    counted around its own steps, must equal its assignment."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.parallel.distributed import \
        DistributedKFAC
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.training import engine

    rank, dev, x, y, local, model, init = _gloo_resnet32(cfg, 300)
    common = dict(inverse_method='eigen', eigh_method='xla',
                  factor_update_freq=1, inv_update_freq=SLICE_INV_FREQ,
                  damping=0.003, lr=0.1, kl_clip=0.001, device=dev)
    report = {'rank': rank, 'cases': []}
    failures = []

    def world(name):
        _, comm, frac, knobs, grid = next(c for c in SLICE_GLOO_CASES
                                          if c[0] == name)
        kfac = KFAC(model, **common, **knobs)
        dk = DistributedKFAC(kfac, comm_method=comm,
                             grad_worker_fraction=frac,
                             num_slices=SLICE_COUNT)
        return {'name': name, 'grid': grid, 'kfac': kfac, 'dk': dk,
                'state': dk.init_state(), 'work': dk.local_work(),
                'launches': dict.fromkeys(kernels.LAUNCHES, 0),
                'step_ms': [], 'records': []}

    def step_world(w, step):
        kfac, dk = w['kfac'], w['dk']
        flags = engine.kfac_step_flags(engine.cadence_flags(
            step, 1, SLICE_INV_FREQ, deferred_reduce=kfac.window_reduce))
        _, _, grads, captures = kfac.capture.loss_and_grads(
            lambda out: F.cross_entropy(out, y[local]), x[local])
        grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
        torch.cuda.synchronize()
        dist.barrier()
        kernels.reset_launches()
        t0 = time.perf_counter()
        precond, w['state'] = dk.step(w['state'], grads, captures, **flags)
        torch.cuda.synchronize()
        w['step_ms'].append((time.perf_counter() - t0) * 1e3)
        for k, v in kernels.LAUNCHES.items():
            w['launches'][k] += v
        w['records'].append({'factors': w['state']['factors'],
                             'precond': precond, 'nu': dk.last_nu.clone()})
        return precond, flags

    def finish(w, errors=()):
        work = w['work']
        expected = dict.fromkeys(kernels.LAUNCHES, 0)
        expected.update({
            'factor_ema': R32_PER_STEP_K1 * SLICE_STEPS,
            'patch_cov': R32_PER_STEP_K2 * SLICE_STEPS,
            'bucket_precond': len(work['precondition']) * SLICE_STEPS})
        dk = w['dk']
        if w['launches'] != expected:
            failures.append(f'{w["name"]}: rank {rank} launches '
                            f'{w["launches"]}, expected {expected} from the '
                            'assignment')
        if (dk.n_rows, dk.n_cols) != w['grid']:
            failures.append(f'{w["name"]}: grid {(dk.n_rows, dk.n_cols)}')
        report['cases'].append({
            'name': w['name'], 'grid': [dk.n_rows, dk.n_cols],
            'slice': dk.groups.slice, 'row': dk.row, 'col': dk.col,
            'work': {k: [list(s) if isinstance(s, tuple) else s
                         for s in v] for k, v in work.items()},
            'launches': w['launches'], 'expected': expected,
            'errors': list(errors), 'step_ms': w['step_ms']})
        w['kfac'].capture.close()

    model.load_state_dict(init)
    flat, hier = world('flat'), world('hierarchical')
    for step in range(SLICE_STEPS):
        precond, _ = step_world(flat, step)
        step_world(hier, step)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= 0.1 * precond[n]
    heads = [s for s in range(SLICE_STEPS) if s % SLICE_INV_FREQ == 0]
    fr, hr = flat['records'], hier['records']
    vs_flat = {
        'factors': _max_rel((hr[s]['factors'][n][k], fr[s]['factors'][n][k])
                            for s in heads for n in fr[s]['factors']
                            for k in 'AG'),
        'precond': _max_rel((hr[s]['precond'][n], fr[s]['precond'][n])
                            for s in range(SLICE_STEPS)
                            for n in fr[s]['precond']),
        'nu': _max_rel((hr[s]['nu'], fr[s]['nu'])
                       for s in range(SLICE_STEPS))}
    bad = {k: v for k, v in vs_flat.items() if not v <= STEP_TOL[k]}
    if bad:
        failures.append(f'hierarchical vs flat: {bad}')
    report['hierarchical_vs_flat'] = vs_flat
    finish(flat)
    finish(hier)

    model.load_state_dict(init)
    low = world('lowrank')
    if not low['work']['stock_precondition'] and rank == 0:
        failures.append('lowrank: rank 0 holds no truncated bucket')
    ref = ref_state = None
    if rank == 0:
        ref = KFAC(model, **common, **next(
            c[3] for c in SLICE_GLOO_CASES if c[0] == 'lowrank'))
        ref_state = ref.init_state()
    errors = []
    for step in range(SLICE_STEPS):
        precond, flags = step_world(low, step)
        if ref is not None:
            _, _, g_full, c_full = ref.capture.loss_and_grads(
                lambda out: F.cross_entropy(out, y), x)
            p_ref, ref_state = ref.step(ref_state, g_full, c_full, **flags)
            norms = [float((precond[n] - p_ref[n]).norm()
                           / p_ref[n].norm().clamp_min(1e-30))
                     for n in p_ref]
            err = {'factors': _max_rel(
                       (low['state']['factors'][n][s],
                        ref_state['factors'][n][s])
                       for n in ref.specs for s in 'AG'),
                   'precond_norm': max(norms),
                   'nu': _max_rel([(low['dk'].last_nu, ref.last_nu)])}
            errors.append(err)
            bad = {k: v for k, v in err.items()
                   if not v <= SLICE_LOWRANK_TOL[k]}
            if bad:
                failures.append(f'lowrank step {step}: {bad}')
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= 0.1 * precond[n]
    finish(low, errors)
    if ref is not None:
        ref.capture.close()
    report['failures'] = failures
    Path(cfg['out']).write_text(json.dumps(report, indent=1))
    dist.destroy_process_group()
    return 1 if failures else 0


def run_slice_gloo_world(card: str) -> dict:
    """Phase 39: GLOO_WORLD ranks of :func:`slice_dist_worker` on the card
    as SLICE_COUNT slices; fails if any rank fails."""
    log(f'  phase 39: ResNet-32, {GLOO_WORLD} ranks on one card over gloo '
        f'as {SLICE_COUNT} slices: the flat and the hierarchical reduce side '
        f'by side, then low-rank; {SLICE_STEPS} steps each, inverses every '
        f'{SLICE_INV_FREQ}')
    t0 = time.perf_counter()
    reports = _run_gloo_ranks('resnet32_slices', timeout=600)
    for rep in reports:
        v = rep['hierarchical_vs_flat']
        log(f'    rank {rep["rank"]} (slice {rep["cases"][0]["slice"]}): '
            f'hierarchical vs flat reduce, factors at the window heads '
            f'{v["factors"]:.2e}, gradients {v["precond"]:.2e}, nu '
            f'{v["nu"]:.2e} (limits {STEP_TOL}); launches = assignment in '
            f'every case: ' + '; '.join(
                f'{c["name"]} row {c["row"]} col {c["col"]} '
                f'{ {k: n for k, n in c["launches"].items() if n} }'
                for c in rep['cases']))
    lowrank = next(c for c in reports[0]['cases'] if c['name'] == 'lowrank')
    worst = {k: max(e[k] for e in lowrank['errors'])
             for k in SLICE_LOWRANK_TOL}
    log(f'  low-rank on {SLICE_COUNT} slices (grid {lowrank["grid"]}; stock '
        f'precondition {lowrank["work"]["stock_precondition"]}): rank 0 vs '
        f'single-device KFAC, worst of {len(lowrank["errors"])} steps: '
        f'factors {worst["factors"]:.2e}, gradients (relative norm) '
        f'{worst["precond_norm"]:.2e}, nu {worst["nu"]:.2e} (limits '
        f'{SLICE_LOWRANK_TOL})')
    total = _launch_total(reports)
    seconds = time.perf_counter() - t0
    log(f'  all ranks: launches {total}; phase 39: {seconds:.1f} s wall '
        f'({card})')
    return {'launches': total, 'ranks': reports, 'seconds': seconds,
            'lowrank_worst': worst}


def run_lowrank_phases(card: str, refs: dict) -> dict:
    """Phases 37-38 (phase 37's ``eigen`` run and phase 39 run in the wave
    of phase 14's worlds); ``refs`` holds phase 15's and phase 23's
    summaries they print beside theirs (None in ``--lowrank-only``)."""
    log(f'== Transformer-XL LM --inv-lowrank-rank {LOWRANK_RANK} (threshold '
        f'{LOWRANK_THRESHOLD}: mlp_in G and mlp_out A engage), {XL_STEPS} '
        'steps auto')
    out = {'transformer_xl_lowrank': run_transformer_xl_lowrank(
        card, refs.get('transformer_xl'))}
    log(f'== config 5 --inv-lowrank-rank {LOWRANK_RANK}: ResNet-152, 224 px, '
        f'batch {R50_BATCH}, --bf16-factors --inverse-method eigen, '
        f'{R152_STEPS} steps on one batch')
    out['resnet152_lowrank'] = run_resnet152_lowrank(
        card, resnet_shapes('resnet152'), refs.get('resnet152_config5'))
    return out


# ---------------------------------------------------------------------------
# Phase 40: the on-device K-FAC metrics, the JSONL sink and the report
# ---------------------------------------------------------------------------

# ResNet-50 through the ImageNet CLI as phase 7 runs it ('auto', one fixed
# batch, so one step and one epoch record per epoch), 12 steps (firings at
# 0 and 10), deterministic cuDNN: once with --kfac-metrics
# --metrics-interval 1 --health-action warn --log-dir, once without.
METRICS_STEPS = 12
# Every gradient-matrix shape of ResNet-50 is a K3 bucket (phase 7).
METRICS_BUCKETS = R50_PER_STEP['bucket_precond']


def _count_device_kernels(fn) -> int:
    """CUDA kernels (and memory copies / sets) ``fn()`` puts on the card,
    from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type.name == 'CUDA')


def _metrics_overhead(state, card: str) -> dict:
    """On the metrics-on run's final state: the device kernels one
    non-firing ResNet-50 step puts on the card with the metrics on (the
    step, the engine's meters and a sink record) and off (the step and
    its loss / accuracy meters), from the profiler; the sink's host ms per
    record and for the drain of 12 records."""
    import tempfile
    import functools
    import torch
    from distributed_kfac_pytorch_tpu_torch.observability import sink as \
        obs_sink
    from distributed_kfac_pytorch_tpu_torch.training import datasets, \
        engine, utils
    (x, y), _ = datasets.get_imagenet(synthetic_size=R50_BATCH)
    xb = torch.as_tensor(x, device='cuda')
    yb = torch.as_tensor(y, dtype=torch.long, device='cuda')
    criterion = functools.partial(utils.label_smooth_loss, smoothing=0.1)
    hyper = {'lr': R50_LR, 'damping': state.kfac.damping}
    flags = {'factor_update': True, 'inv_update': False}
    tmp = Path(tempfile.mkdtemp(prefix='kfac-drain-'))
    sink = obs_sink.JsonlMetricsSink(str(tmp / 'steps.jsonl'),
                                     drain_every=10**6)
    meters: dict = {}

    def step(collect: bool):
        state.kfac.collect_metrics = collect
        loss, acc = engine.train_step(state, xb, yb, hyper, flags, criterion)
        metrics = (engine.step_metrics(state, loss, acc) if collect
                   else {'loss': loss, 'acc': acc})
        for k, v in metrics.items():
            meters.setdefault(k, utils.Metric(k)).update(v)
        if collect:
            engine.record_step(sink, state.step, metrics, 0.0, 'factor')

    kernels_on = _count_device_kernels(lambda: step(True))
    kernels_off = _count_device_kernels(lambda: step(False))
    state.kfac.collect_metrics = True
    metrics = engine.step_metrics(state, torch.zeros((), device='cuda'),
                                  torch.zeros((), device='cuda'))
    timed = obs_sink.JsonlMetricsSink(str(tmp / 'timed.jsonl'),
                                      drain_every=10**6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(METRICS_STEPS):
        timed.step_record(i, metrics)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / METRICS_STEPS
    t0 = time.perf_counter()
    timed.flush()
    drain_ms = (time.perf_counter() - t0) * 1e3
    sink.close()
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    out = {'kernels_on': kernels_on, 'kernels_off': kernels_off,
           'kernels_added': kernels_on - kernels_off,
           'record_enqueue_ms': enqueue_ms,
           'drain_ms_12_records': drain_ms,
           'metrics_per_record': len(metrics)}
    log(f'  device kernels per non-firing step (profiler): metrics on '
        f'{kernels_on}, off {kernels_off}: the metrics add '
        f'{out["kernels_added"]}; a step record ({len(metrics)} scalars) '
        f'takes {enqueue_ms:.3f} ms of host time to enqueue, the drain of '
        f'{METRICS_STEPS} records {drain_ms:.2f} ms ({card})')
    return out


def run_metrics_phase(card: str) -> dict:
    """Phase 40: ResNet-50 through ``train_imagenet_resnet.train`` with the
    metrics stream on, then off (launch counts reset before each run and
    read after it); the two runs' losses and final parameters equal bit
    for bit; the stream, read by the port's ``report --json``: 12 step
    records, their 12 epoch records, the two meta records,
    ``kfac/factor_updates``
    1..12, ``kfac/inv_updates`` stepping at steps 0 and 10, ``nu`` <= 1,
    finite norms, the bucket keys those the run's ``KFAC`` preconditions
    (21), no health event; the median non-firing step with the metrics on
    and off, the kernels they add and the sink's host time."""
    import contextlib
    import io
    import shutil
    import tempfile
    import torch
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet
    from distributed_kfac_pytorch_tpu_torch.observability import report
    from distributed_kfac_pytorch_tpu_torch.observability import sink as \
        obs_sink
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix='kfac-metrics-'))
    path = tmp / 'kfac_metrics.jsonl'
    base = _r50_config(epochs=METRICS_STEPS, deterministic=True)
    configs = {'on': {**base, 'kfac_metrics': str(path),
                      'metrics_interval': 1, 'health_action': 'warn',
                      'log_dir': str(tmp / 'logs')},
               'off': base}
    # Kernel loads of earlier phases are not this run's compile events.
    kernels.drain_build_events()
    runs, params = {}, {}
    for label, config in configs.items():
        _release()
        kernels.reset_launches()
        with _cudnn_flags():
            res = train_imagenet_resnet.train(config, device='cuda')
        res['launches'] = dict(kernels.LAUNCHES)
        state = res.pop('state')
        params[label] = {n: p.detach().clone()
                         for n, p in state.model.named_parameters()}
        if label == 'on':
            bucket_keys = state.kfac.metric_bucket_keys()
            overhead = _metrics_overhead(state, card)
        del state
        runs[label] = res
    on, off = runs['on'], runs['off']
    expected = {k: v * METRICS_STEPS for k, v in R50_PER_STEP.items()}
    expected.update(ns_inverse=0, jacobi_eigh=0)
    for label, res in runs.items():
        if res['launches'] != expected or res['steps'] != METRICS_STEPS:
            raise AssertionError(f'metrics {label}: {res["steps"]} steps, '
                                 f'launches {res["launches"]}, expected '
                                 f'{expected}')
    if on['losses'] != off['losses']:
        raise AssertionError(f'metrics on changed the losses: '
                             f'{on["losses"]} vs {off["losses"]}')
    differ = [n for n, p in params['on'].items()
              if not torch.equal(p, params['off'][n])]
    if differ:
        raise AssertionError(f'metrics on changed the parameters: '
                             f'{differ[:5]}')
    del params
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report.main([str(path), '--json'])
    summary = json.loads(buf.getvalue())
    records = obs_sink.read_jsonl(str(path))
    steps = [r for r in records if r['kind'] == 'step']
    kinds = [r['kind'] for r in records]
    factor = [r['metrics']['kfac/factor_updates'] for r in steps]
    inv = [r['metrics']['kfac/inv_updates'] for r in steps]
    nus = [r['metrics']['kfac/nu'] for r in steps]
    norms = [r['metrics'][k] for r in steps for k in r['metrics']
             if k.endswith('_norm') or '/bucket_norm/' in k]
    keys = sorted({k.split('/', 2)[2] for r in steps for k in r['metrics']
                   if k.startswith('kfac/bucket_norm/')})
    problems = []
    # One fixed batch per epoch (phase 7's config): an epoch record each.
    if rc != 0 or summary['n_steps'] != METRICS_STEPS \
            or summary['n_epochs'] != METRICS_STEPS \
            or kinds.count('meta') != 2:
        problems.append(f'report rc {rc}, {summary["n_steps"]} steps, '
                        f'{summary["n_epochs"]} epochs, kinds {kinds}')
    if [r['step'] for r in steps] != list(range(METRICS_STEPS)):
        problems.append(f'step records {[r["step"] for r in steps]}')
    if factor != [float(i + 1) for i in range(METRICS_STEPS)]:
        problems.append(f'factor_updates {factor}')
    want_inv = [1.0 + (i >= R50_FIRE_EVERY) for i in range(METRICS_STEPS)]
    if inv != want_inv:
        problems.append(f'inv_updates {inv}, want {want_inv}')
    if not all(isinstance(v, float) and v <= 1.0 for v in nus):
        problems.append(f'nu {nus}')
    if not all(isinstance(v, float) and math.isfinite(v) for v in norms):
        problems.append('non-finite norms')
    if keys != sorted(bucket_keys) or len(keys) != METRICS_BUCKETS:
        problems.append(f'bucket keys {keys}, the KFAC preconditions '
                        f'{bucket_keys}')
    if summary['health_events']:
        problems.append(f'health events {summary["health_events"]}')
    if problems:
        raise AssertionError('metrics stream: ' + '; '.join(problems))
    med = {label: statistics.median(_step_ms(res)[1][1:])
           for label, res in runs.items()}
    shutil.rmtree(tmp, ignore_errors=True)
    out = {'losses': on['losses'], 'launches': {
               k: on['launches'][k] + off['launches'][k] for k in expected},
           'nonfiring_ms_median': med,
           'overhead_ms': med['on'] - med['off'],
           'overhead_share': (med['on'] - med['off']) / med['off'],
           'step_ms': {k: r['step_ms'] for k, r in runs.items()},
           'report': {k: summary[k] for k in ('n_records', 'n_steps',
                                               'n_epochs', 'kfac',
                                               'health_events',
                                               'step_time')},
           'bucket_keys': keys, 'nu': nus, **overhead,
           'seconds': time.perf_counter() - t0}
    log(f'  metrics on and off: losses and final parameters equal bit for '
        f'bit; launches per run {on["launches"]}')
    log(f'  stream: {len(records)} records ({kinds.count("step")} step, '
        f'{kinds.count("epoch")} epoch, {kinds.count("meta")} meta, '
        f'{kinds.count("event")} event), factor_updates 1..{METRICS_STEPS}, '
        f'inv_updates {[int(v) for v in inv]}, nu {min(nus):.4g}..'
        f'{max(nus):.4g}, {len(keys)} bucket keys, no health events')
    log(f'  non-firing ms/step (median of {METRICS_STEPS - 3}): metrics on '
        f'{med["on"]:.2f}, off {med["off"]:.2f}, difference '
        f'{out["overhead_ms"]:+.2f} ({out["overhead_share"]:+.2%}) ({card})')
    log(f'  phase 40: {out["seconds"]:.1f} s wall')
    return out


# ---------------------------------------------------------------------------
# Phases 41-43: the rest of observability and self-healing
# ---------------------------------------------------------------------------

# Phase 41: phase 40's ResNet-50 run on two fixed batches (two steps per
# epoch: the profiled first epoch holds the firing step 0 and the plain
# step 1), 13 steps, memory records every 4: the last at the last step,
# whose running peak covers every step before it.
OBS_STEPS, OBS_MEMORY_EVERY = 13, 4
# The kfac/* scopes a ResNet-50 'auto' step reaches (eigen sides <= 640,
# Cholesky above; every bucket through K3).
OBS_SCOPES = ('kfac/factors', 'kfac/factors/conv2d_a', 'kfac/factors/conv2d_g',
              'kfac/factors/linear_a', 'kfac/factors/linear_g',
              'kfac/inverses', 'kfac/eigh/warm', 'kfac/inverse/cholesky',
              'kfac/precond', 'kfac/precond/inv')
# Each kernel's launches sit inside a scope of its stage.
OBS_STAGE_OF = {'K1 factor_ema': 'kfac/factors/', 'K2 patch_cov':
                'kfac/factors/', 'K3 bucket_precond': 'kfac/precond/'}
OBS_COARSE = ('kfac/factors', 'kfac/inverses', 'kfac/precond')


def _trace_scopes(path: str) -> dict:
    """A Chrome trace of ``torch.profiler``, read: each ``kfac/*`` scope's
    host intervals, and each CUDA kernel with the scopes its launch sat
    in (its runtime or driver launch call, matched by correlation id)."""
    events = json.loads(Path(path).read_text())['traceEvents']
    scopes, launches, kernels_ = [], {}, []
    for ev in events:
        cat, args = ev.get('cat', ''), ev.get('args') or {}
        if cat == 'user_annotation' and ev.get('name', '').startswith(
                'kfac/'):
            scopes.append((ev['name'], ev['ts'], ev['ts'] + ev['dur'],
                           ev.get('pid'), ev.get('tid')))
        elif cat in ('cuda_runtime', 'cuda_driver') and \
                'correlation' in args:
            launches[args['correlation']] = (ev['ts'], ev.get('pid'),
                                             ev.get('tid'))
        elif cat == 'kernel':
            kernels_.append((ev['name'], ev.get('dur', 0.0),
                             args.get('correlation')))
    out = []
    for name, dur, corr in kernels_:
        at = launches.get(corr)
        inside = ([s[0] for s in scopes if s[3] == at[1] and s[4] == at[2]
                   and s[1] <= at[0] <= s[2]] if at else [])
        out.append({'name': name, 'us': dur, 'launch_ts': at and at[0],
                    'scopes': inside})
    return {'scopes': scopes, 'kernels': out}


def _scope_table(trace: dict) -> list:
    """Device ms per ``kfac/*`` scope of each step in the trace (a step
    ends with its coarse ``kfac/precond`` scope): the kernels whose launch
    sat inside the scope (nested scopes counted in each), and the step's
    kernels in no scope (the model's)."""
    ends = sorted(s[2] for s in trace['scopes'] if s[0] == 'kfac/precond')
    steps = []
    start = -math.inf
    for end in ends:
        ms, total, outside = {}, 0.0, 0.0
        for k in trace['kernels']:
            t = k['launch_ts']
            if t is None or not start < t <= end:
                continue
            total += k['us'] / 1e3
            if not k['scopes']:
                outside += k['us'] / 1e3
            for name in set(k['scopes']):
                ms[name] = ms.get(name, 0.0) + k['us'] / 1e3
        steps.append({'by_scope_ms': dict(sorted(ms.items())),
                      'device_ms': total, 'outside_kfac_ms': outside})
        start = end
    return steps


def _gate(argv) -> tuple[int, dict | str]:
    """The port's ``observability.gate`` in this process: ``(exit code,
    its --json verdict or its text)``."""
    import io
    from distributed_kfac_pytorch_tpu_torch.observability import gate
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = gate.main(argv)
    text = buf.getvalue()
    return rc, json.loads(text) if '--json' in argv else text


def _memory_record_cost(state, card: str) -> dict:
    """Host ms of one memory record's parts on the card: the allocator
    read, the state footprint (once per epoch in the engine) and the
    sink's enqueue; 200 of each."""
    import tempfile
    from distributed_kfac_pytorch_tpu_torch.observability import memory
    from distributed_kfac_pytorch_tpu_torch.observability import sink as \
        obs_sink
    tmp = Path(tempfile.mkdtemp(prefix='kfac-mem-'))
    s = obs_sink.JsonlMetricsSink(str(tmp / 'm.jsonl'), drain_every=10**6)
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        stats = memory.device_memory_stats('cuda')
    stats_ms = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        foot = memory.state_footprint(state.kfac_state)
    foot_ms = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for i in range(reps):
        s.memory_record(i, device=stats, state=foot)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / reps
    s.close()
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    out = {'device_stats_ms': stats_ms, 'state_footprint_ms': foot_ms,
           'enqueue_ms': enqueue_ms,
           'record_ms': stats_ms + enqueue_ms}
    log(f'  a memory record\'s host cost: allocator read {stats_ms:.4f} ms '
        f'+ enqueue {enqueue_ms:.4f} ms; the state footprint (once per '
        f'epoch) {foot_ms:.4f} ms ({card})')
    return out


def run_observability_phase(card: str) -> dict:
    """Phase 41: ResNet-50 through ``train_imagenet_resnet.train`` (224
    px, batch 64, ``auto``, two fixed batches, 12 steps, firings at 0 and
    10, ``--deterministic``) with ``--kfac-metrics --metrics-interval 1
    --memory-interval 4 --profile-dir`` and again with ``--kfac-metrics``
    alone (launch counts reset before each run, read after it). Holds:
    the losses and final parameters equal bit for bit, phase 7's launches
    per step in both; the Chrome trace of the first epoch holds every
    ``kfac/*`` scope of ``OBS_SCOPES``, each K1, K2 and K3 launch inside a
    scope of its stage (``kfac/factors/*``, ``kfac/precond/*``); device ms
    per scope of the firing step 0 and the plain step 1; the memory
    records' peak within 1 % of ``torch.cuda.max_memory_allocated()``,
    their state footprint the sum of the state's tensor bytes; every epoch
    record carries the trace table; the port's ``gate`` passes against a
    baseline written from the stream and fails against one with a broken
    tolerance; the profiler's cost on step 1 and the host cost of a
    memory record."""
    import shutil
    import tempfile
    import torch
    from distributed_kfac_pytorch_tpu_torch import train_imagenet_resnet, \
        utils
    from distributed_kfac_pytorch_tpu_torch.observability import profiling
    from distributed_kfac_pytorch_tpu_torch.observability import sink as \
        obs_sink
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix='kfac-obs-'))
    base = _r50_config(epochs=(OBS_STEPS + 1) // 2, max_steps=OBS_STEPS,
                       synthetic_size=2 * R50_BATCH, deterministic=True,
                       metrics_interval=1)
    configs = {'on': {**base, 'kfac_metrics': str(tmp / 'on.jsonl'),
                      'memory_interval': OBS_MEMORY_EVERY,
                      'profile_dir': str(tmp / 'prof')},
               'off': {**base, 'kfac_metrics': str(tmp / 'off.jsonl')}}
    kernels.drain_build_events()
    runs, params = {}, {}
    for label, config in configs.items():
        _release()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with _cudnn_flags():
            res = train_imagenet_resnet.train(config, device='cuda')
        res['launches'] = dict(kernels.LAUNCHES)
        res['max_allocated'] = torch.cuda.max_memory_allocated()
        state = res.pop('state')
        params[label] = {n: p.detach().clone()
                         for n, p in state.model.named_parameters()}
        if label == 'on':
            state_bytes = utils.tree_bytes(state.kfac_state)
            cost = _memory_record_cost(state, card)
        del state
        runs[label] = res
    on, off = runs['on'], runs['off']
    expected = {k: v * OBS_STEPS for k, v in R50_PER_STEP.items()}
    expected.update(ns_inverse=0, jacobi_eigh=0)
    problems = []
    for label, res in runs.items():
        if res['launches'] != expected or res['steps'] != OBS_STEPS:
            problems.append(f'{label}: {res["steps"]} steps, launches '
                            f'{res["launches"]}, expected {expected}')
    if on['losses'] != off['losses']:
        problems.append(f'losses {on["losses"]} vs {off["losses"]}')
    differ = [n for n, p in params['on'].items()
              if not torch.equal(p, params['off'][n])]
    if differ:
        problems.append(f'parameters differ: {differ[:5]}')
    del params
    files = profiling.trace_files(str(tmp / 'prof'))
    if len(files) != 1:
        raise AssertionError(f'phase 41: trace files {files}')
    trace = _trace_scopes(files[0])
    found = sorted({s[0] for s in trace['scopes']})
    missing = [s for s in OBS_SCOPES if s not in found]
    if missing:
        problems.append(f'scopes missing from the trace: {missing}')
    placed = {}
    for k in trace['kernels']:
        cat = _category(k['name'])
        stage = OBS_STAGE_OF.get(cat)
        if stage is None:
            continue
        ok = any(s.startswith(stage) for s in k['scopes'])
        n, good = placed.get(cat, (0, 0))
        placed[cat] = (n + 1, good + ok)
    for cat in OBS_STAGE_OF:
        n, good = placed.get(cat, (0, 0))
        if n == 0 or good != n:
            problems.append(f'{cat}: {good} of {n} kernels inside their '
                            f'stage scope')
    table = _scope_table(trace)
    if len(table) != 2:
        problems.append(f'{len(table)} steps in the profiled epoch')
    records = obs_sink.read_jsonl(configs['on']['kfac_metrics'])
    mem = [r for r in records if r['kind'] == 'memory']
    epochs = [r for r in records if r['kind'] == 'epoch']
    peaks = [r['device']['peak_bytes_in_use'] for r in mem]
    peak = max(peaks, default=0)
    if [r['step'] for r in mem] != list(range(0, OBS_STEPS,
                                              OBS_MEMORY_EVERY)):
        problems.append(f'memory records at {[r["step"] for r in mem]}')
    if not mem or abs(peak - on['max_allocated']) > 0.01 * on[
            'max_allocated']:
        problems.append(f'memory peaks {peaks} against '
                        f'max_memory_allocated {on["max_allocated"]}')
    totals = {r['state']['total_bytes'] for r in mem}
    if totals != {state_bytes}:
        problems.append(f'state footprint {totals}, tensor bytes '
                        f'{state_bytes}')
    if len(epochs) != (OBS_STEPS + 1) // 2 or not all(
            'train_step_dispatch' in r.get('trace', {}) for r in epochs):
        problems.append('epoch records without the trace table')
    baseline, broken = str(tmp / 'base.json'), str(tmp / 'broken.json')
    stream = configs['on']['kfac_metrics']
    rc_write, _ = _gate([stream, '--write-baseline', baseline])
    rc_pass, verdict = _gate([stream, '--baseline', baseline, '--json'])
    obj = json.loads(Path(baseline).read_text())
    obj['metrics']['step_p50_ms'] *= 0.5        # a tolerance broken
    Path(broken).write_text(json.dumps(obj))
    rc_fail, verdict_fail = _gate([stream, '--baseline', broken, '--json'])
    if (rc_write, rc_pass) != (0, 0) or rc_fail == 0:
        problems.append(f'gate exit codes {rc_write}, {rc_pass}, {rc_fail}')
    if problems:
        raise AssertionError('phase 41: ' + '; '.join(problems))
    prof_ms, plain_ms = on['step_ms'][1], off['step_ms'][1]
    later = statistics.median(off['step_ms'][3:10:2])
    out = {'launches': {k: on['launches'][k] + off['launches'][k]
                        for k in expected},
           'losses': on['losses'], 'scopes_found': found,
           'kernels_in_stage_scope': {k: list(v) for k, v in placed.items()},
           'per_scope': {'firing_step0': table[0], 'plain_step1': table[1]},
           'step_ms': {k: r['step_ms'] for k, r in runs.items()},
           'profiled_step1_ms': prof_ms, 'unprofiled_step1_ms': plain_ms,
           'unprofiled_plain_median_ms': later,
           'memory_peak_bytes': peak, 'memory_record_peaks': peaks,
           'max_allocated': on['max_allocated'],
           'state_bytes': state_bytes, 'memory_record': cost,
           'gate': {'pass': verdict, 'broken': verdict_fail['breaches']},
           'seconds': time.perf_counter() - t0}
    shutil.rmtree(tmp, ignore_errors=True)
    log(f'  --profile-dir and --memory-interval on and off: losses and final '
        f'parameters equal bit for bit; launches per run {on["launches"]}')
    log(f'  trace: {len(found)} kfac/* scopes {found}; kernels inside their '
        f'stage scope (of all): '
        f'{ {k: f"{g}/{n}" for k, (n, g) in placed.items()} }')
    for label, row in (('firing step 0', table[0]),
                       ('plain step 1', table[1])):
        coarse = {k: round(v, 3) for k, v in row['by_scope_ms'].items()
                  if k in OBS_COARSE or k.startswith('kfac/comm')}
        log(f'  device ms per scope, {label}: {coarse}; step '
            f'{row["device_ms"]:.3f}, outside kfac/* '
            f'{row["outside_kfac_ms"]:.3f} ({card})')
        log(f'    finer: { {k: round(v, 3) for k, v in row["by_scope_ms"].items() if k not in OBS_COARSE} }')
    log(f'  step 1 under the profiler {prof_ms:.2f} ms, unprofiled '
        f'{plain_ms:.2f} (later plain steps unprofiled, median '
        f'{later:.2f}) ({card})')
    log(f'  memory records at {[r["step"] for r in mem]}: running peaks '
        f'{peaks} B, max_memory_allocated {on["max_allocated"]} B; state '
        f'footprint {state_bytes} B = the state\'s tensor bytes; gate: pass '
        f'against the stream\'s baseline, exit {rc_fail} with step_p50_ms '
        f'halved')
    log(f'  phase 41: {out["seconds"]:.1f} s wall ({card})')
    return out


# Phase 42: ResNet-32 at full width through the CIFAR CLI, one card.
SELFHEAL_R32 = {'model': 'resnet32', 'batch_size': 128,
                'val_batch_size': 128, 'synthetic_size': 1280,
                'no_augment': True, 'seed': 0, 'kfac_update_freq': 10,
                'deterministic': True, 'quiet': True, 'time_steps': True,
                'metrics_interval': 1}
SELFHEAL_DIVERGE_AT, SELFHEAL_CORRUPT_AT = 6, 3
SELFHEAL_PRECOND_TOL = 1e-4
SELFHEAL_NU_TOL = 1e-6


@contextlib.contextmanager
def _chaos(spec: str | None):
    old = os.environ.pop('KFAC_CHAOS', None)
    if spec:
        os.environ['KFAC_CHAOS'] = spec
    try:
        yield
    finally:
        os.environ.pop('KFAC_CHAOS', None)
        if old is not None:
            os.environ['KFAC_CHAOS'] = old


@contextlib.contextmanager
def _gated_steps_held(record: list):
    """Within the block, every ``KFAC.precondition`` with gates is held
    against a second call on the same inputs: with a gate off, the same
    gates on the stock path (``fused_precondition=False``: no K3), per
    tensor within ``SELFHEAL_PRECOND_TOL``; with every gate on, the call
    without gates (K3's fused ``v.g``), ``nu`` within ``SELFHEAL_NU_TOL``.
    ``record`` gets each step's K3 launches, largest error and ``nu``s;
    the second call's launches are taken back off the counts."""
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    orig = KFAC.precondition

    def checked(self, state, grads, damping, lr, with_stats=False,
                gates=None):
        before = kernels.LAUNCHES['bucket_precond']
        out = orig(self, state, grads, damping, lr, with_stats=with_stats,
                   gates=gates)
        if gates is None:
            return out
        k3 = kernels.LAUNCHES['bucket_precond'] - before
        counts = dict(kernels.LAUNCHES)
        nu = self.last_nu
        off = sorted(k for k, g in gates.items() if float(g) < 0.5)
        try:
            if off:
                self.fused_precondition = False
                ref = orig(self, state, grads, damping, lr, gates=gates)
            else:
                ref = orig(self, state, grads, damping, lr)
            ref_nu = self.last_nu
        finally:
            self.fused_precondition = True
            self.last_nu = nu
            kernels.LAUNCHES.update(counts)
        got = out[0] if with_stats else out
        err = max(_tensor_rel(got[k], ref[k]) for k in ref)
        record.append({'k3_launches': k3, 'max_rel': err,
                       'nu': float(nu), 'ref_nu': float(ref_nu),
                       'nu_gap': abs(float(nu) / float(ref_nu) - 1.0),
                       'gated': off})
        return out

    KFAC.precondition = checked
    try:
        yield
    finally:
        KFAC.precondition = orig


def _selfheal_run(label: str, extra: dict, tmp: Path,
                  chaos: str | None = None, observers=True) -> dict:
    """One ResNet-32 CLI run of phase 42 (launch counts reset before it),
    its stream's selfheal events and final parameters."""
    import torch
    from distributed_kfac_pytorch_tpu_torch import train_cifar10_resnet
    from distributed_kfac_pytorch_tpu_torch.observability import sink as \
        obs_sink
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.training import engine
    stream = tmp / f'{label}.jsonl'
    config = {**SELFHEAL_R32, 'kfac_metrics': str(stream), **extra}
    _release()
    kernels.reset_launches()
    real = engine.make_observers
    if not observers:
        engine.make_observers = lambda *a, **k: None
    try:
        with _cudnn_flags(), _chaos(chaos):
            res = train_cifar10_resnet.train(config, device='cuda')
    finally:
        engine.make_observers = real
    res['launches'] = dict(kernels.LAUNCHES)
    state = res.pop('state')
    res['params'] = {n: p.detach().clone()
                     for n, p in state.model.named_parameters()}
    del state
    records = obs_sink.read_jsonl(str(stream))
    res['records'] = records
    res['events'] = [(r['event'], r['data']) for r in records
                     if r['kind'] == 'event'
                     and r['event'].startswith('selfheal')]
    res['nu'] = [r['metrics']['kfac/nu'] for r in records
                 if r['kind'] == 'step']
    return res


def run_selfheal_phase(card: str) -> dict:
    """Phase 42: self-healing on ResNet-32 at full width through
    ``train_cifar10_resnet.train`` (batch 128, ``auto``, firings every
    10 steps, ``--deterministic``, ``--kfac-metrics --metrics-interval
    1``):
      1. ``KFAC_CHAOS=diverge@6 --selfheal --selfheal-window 2
         --selfheal-diverge-ratio 3``, step bundles every 2 steps, 3
         epochs: damping escalations, then one in-process rollback to the
         newest verified, finite bundle before the fault; the process
         finishes every epoch, the losses after the rollback finite and
         falling; the port's ``gate`` counts one rollback;
      2. ``KFAC_CHAOS=corrupt-factor@3 --selfheal --selfheal-window 1``,
         2 epochs: the quarantine of the 16x27 bucket (``conv1``), every
         gated step through K3 and held against the stock path with the
         same gates, the re-admission after the step-10 firing;
      3. ``--selfheal`` with no fault, 2 epochs: at every step the gated
         call (every gate on: the full-tensor ``v.g``) against the same
         call without gates (K3's fused ``v.g``), ``nu`` within 1e-6;
      4. unarmed, 2 epochs, against the same run with the engine's
         observers taken out: losses and parameters bit for bit, phase 5's
         launches per step."""
    import shutil
    import tempfile
    from distributed_kfac_pytorch_tpu_torch.observability import gate
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix='kfac-selfheal-'))
    problems = []
    steps = SELFHEAL_R32['synthetic_size'] // SELFHEAL_R32['batch_size']
    # 1. diverge -> escalate -> rollback.
    div = _selfheal_run('diverge', {
        'epochs': 3, 'selfheal': True, 'selfheal_window': 2,
        'selfheal_diverge_ratio': 3.0,
        'checkpoint_dir': str(tmp / 'ck_div'), 'checkpoint_steps': 2},
        tmp, chaos=f'diverge@{SELFHEAL_DIVERGE_AT}')
    names = [e for e, _ in div['events']]
    rb = [d for e, d in div['events'] if e == 'selfheal_rollback']
    counted = gate.gate_metrics(div['records'])['selfheal_rollbacks']
    after = div['losses'][-(3 * steps - rb[0]['to_step']):] if rb else []
    if not names or names[0] != 'selfheal_escalate' or len(rb) != 1 \
            or counted != 1 or len(div['rollbacks']) != 1 \
            or div['steps'] != 3 * steps:
        problems.append(f'diverge: events {names}, rollbacks '
                        f'{div["rollbacks"]}, gate counts {counted}, steps '
                        f'{div["steps"]}')
    elif not (all(math.isfinite(v) for v in after)
              and statistics.mean(after[-3:]) < statistics.mean(after[:3])
              and rb[0]['to_step'] <= SELFHEAL_DIVERGE_AT):
        problems.append(f'diverge: after the rollback to step '
                        f'{rb[0]["to_step"]}: losses {after}')
    # 2. corrupt-factor -> quarantine -> readmit, gated steps held.
    calls: list = []
    with _gated_steps_held(calls):
        cor = _selfheal_run('corrupt', {
            'epochs': 2, 'selfheal': True, 'selfheal_window': 1},
            tmp, chaos=f'corrupt-factor@{SELFHEAL_CORRUPT_AT}')
    held = [c for c in calls if c['gated']]
    cnames = [e for e, _ in cor['events']]
    quarantined = [d['bucket'] for e, d in cor['events']
                   if e == 'selfheal_quarantine']
    worst = max((h['max_rel'] for h in held), default=math.inf)
    if quarantined != ['16x27'] or 'selfheal_readmit' not in cnames \
            or cor['rollbacks']:
        problems.append(f'corrupt-factor: events {cnames}, rollbacks '
                        f'{cor["rollbacks"]}')
    if not held or worst > SELFHEAL_PRECOND_TOL or any(
            h['k3_launches'] != EXPECTED_PER_STEP['bucket_precond']
            for h in held):
        problems.append(f'gated steps: {held}')
    if not all(math.isfinite(v) for v in cor['losses']):
        problems.append(f'corrupt-factor losses {cor["losses"]}')
    # 3-4. armed without a fault (every step's gated call against the
    # same call without gates); unarmed, with and without observers.
    on_calls: list = []
    with _gated_steps_held(on_calls):
        armed = _selfheal_run('armed', {'epochs': 2, 'selfheal': True}, tmp)
    plain = _selfheal_run('plain', {'epochs': 2}, tmp)
    bare = _selfheal_run('bare', {'epochs': 2}, tmp, observers=False)
    nu_gap = max((c['nu_gap'] for c in on_calls), default=math.inf)
    on_err = max((c['max_rel'] for c in on_calls), default=math.inf)
    nu_trajectory = max(abs(a / b - 1.0) for a, b in zip(armed['nu'],
                                                         plain['nu']))
    if nu_gap > SELFHEAL_NU_TOL or len(on_calls) != 2 * steps \
            or armed['events'] or any(c['gated'] for c in on_calls):
        problems.append(f'armed: {len(on_calls)} gated calls, nu gap '
                        f'{nu_gap:.3e}, events {armed["events"]}')
    want = {k: v * 2 * steps for k, v in EXPECTED_PER_STEP.items()}
    want['jacobi_eigh'] = 0
    if plain['losses'] != bare['losses'] or any(
            not _tensor_rel(p, bare['params'][n]) == 0.0
            for n, p in plain['params'].items()) \
            or plain['launches'] != want or bare['launches'] != want:
        problems.append(f'unarmed: losses {plain["losses"][:3]} vs '
                        f'{bare["losses"][:3]}, launches '
                        f'{plain["launches"]} / {bare["launches"]}, plan '
                        f'{want}')
    if problems:
        raise AssertionError('phase 42: ' + '; '.join(problems))
    runs = (div, cor, armed, plain, bare)
    launches = {k: sum(r['launches'].get(k, 0) for r in runs)
                for k in div['launches']}
    out = {'launches': launches,
           'diverge': {'events': div['events'], 'rollbacks':
                       div['rollbacks'], 'losses': div['losses']},
           'corrupt': {'events': cor['events'], 'held': held,
                       'losses': cor['losses']},
           'armed_nu_gap': nu_gap, 'armed_precond_gap': on_err,
           'armed_vs_unarmed_nu_trajectory': nu_trajectory,
           'step_ms': {'armed': armed['step_ms'], 'plain': plain['step_ms']},
           'seconds': time.perf_counter() - t0}
    shutil.rmtree(tmp, ignore_errors=True)
    log(f'  diverge@{SELFHEAL_DIVERGE_AT}: {names}; rolled back from step '
        f'{rb[0]["from_step"]} to {rb[0]["to_step"]} in the process, '
        f'{div["steps"]} steps done, losses after it '
        f'{after[0]:.4f} -> {after[-1]:.4f}; gate counts {counted} rollback')
    log(f'  corrupt-factor@{SELFHEAL_CORRUPT_AT}: {cnames}; {len(held)} gated '
        f'steps, each K3 x {held[0]["k3_launches"]}, against the stock path '
        f'max rel {worst:.2e} (tol {SELFHEAL_PRECOND_TOL})')
    log(f'  --selfheal without a fault: on each of {len(on_calls)} steps the '
        f'gated call (all on, full-tensor v.g) against the same call without '
        f'gates (K3\'s v.g): nu within {nu_gap:.2e}, gradients {on_err:.2e} '
        f'(the two runs\' nu part by {nu_trajectory:.2e} over the steps: '
        f'a chaotic trajectory); unarmed equal bit for bit to the run without '
        f'observers, launches {want}')
    log(f'  phase 42: {out["seconds"]:.1f} s wall ({card})')
    return out


# Phase 43: straggler shards on GLOO_WORLD gloo ranks of cuda:0.
SHARDS_STEPS = 4
SHARDS_GATES = {'all_on': (), 'conv1_off': ('16x27',), 'all_off': 'all'}


def shards_dist_worker(cfg: dict) -> int:
    """One rank of phase 43 (``chip_smoke.py --dist-worker CONFIG``, the
    torchrun environment set): the CIFAR CLI at ResNet-32 with
    ``--num-slices 2 --hierarchical-reduce --kfac-metrics
    --straggler-shards --straggler-sample-every 2 --use-inv-kfac``, then
    on the run's final state ``DistributedKFAC.precondition(gates=)`` of a
    world-mean gradient under each of ``SHARDS_GATES``; rank 0 holds each
    against the single-device ``KFAC`` on the same factors, its inverses
    fired at the same damping (``STEP_TOL``), and each gated layer to its
    raw gradient times ``nu``, exactly."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from distributed_kfac_pytorch_tpu_torch import launch, \
        train_cifar10_resnet
    from distributed_kfac_pytorch_tpu_torch.ops import kernels
    from distributed_kfac_pytorch_tpu_torch.preconditioner import KFAC
    from distributed_kfac_pytorch_tpu_torch.resilience import selfheal
    from distributed_kfac_pytorch_tpu_torch.training import engine
    rank = int(os.environ['RANK'])
    report = {'rank': rank, 'failures': []}
    kernels.reset_launches()
    res = train_cifar10_resnet.train({
        'model': 'resnet32', 'batch_size': GLOO_BATCH,
        'val_batch_size': GLOO_BATCH,
        'synthetic_size': GLOO_BATCH * SHARDS_STEPS, 'epochs': 1,
        'no_augment': True, 'seed': 0, 'kfac_update_freq': 2,
        'use_inv_kfac': True, 'dist_backend': 'gloo', 'num_slices': 2,
        'hierarchical_reduce': True, 'kfac_metrics': cfg['stream'],
        'metrics_interval': 1, 'straggler_shards': True,
        'straggler_sample_every': 2, 'quiet': True}, device='cuda')
    report['run_launches'] = dict(kernels.LAUNCHES)
    report['losses'] = res['losses']
    state = res['state']
    dk, kfac, model = state.kfac, state.kfac.kfac, state.model
    dev = torch.device('cuda:0')
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(GLOO_BATCH, 3, 32, 32, generator=gen).to(dev)
    y = torch.randint(0, 10, (GLOO_BATCH,), generator=gen).to(dev)
    local = launch.process_local_slice(GLOO_BATCH)
    model.eval()
    _, _, grads, _ = kfac.capture.loss_and_grads(
        lambda out: F.cross_entropy(out, y[local]), x[local],
        intercept=False)
    grads = dict(zip(grads, engine.world_mean(list(grads.values()))))
    damping, lr = kfac.damping, 0.1
    ref = ref_state = None
    if rank == 0:
        ref = KFAC(model, device=dev, inverse_method='cholesky',
                   factor_update_freq=1, inv_update_freq=2,
                   damping=damping, kl_clip=kfac.kl_clip)
        fresh = ref.init_state()
        ref_state = {**fresh, 'factors': {
            n: {k: t.clone() for k, t in e.items()}
            for n, e in state.kfac_state['factors'].items()}}
        ref_state['inverses'] = ref.update_inverses(ref_state, damping)
    buckets = selfheal.bucket_layer_map(kfac)
    keys = kfac.metric_bucket_keys()
    errors = {}
    k3 = 0
    for label, off in SHARDS_GATES.items():
        off = keys if off == 'all' else off
        gates = {k: torch.tensor(0.0 if k in off else 1.0, device=dev)
                 for k in keys}
        before = kernels.LAUNCHES['bucket_precond']
        out = dk.precondition(state.kfac_state, dict(grads), damping, lr,
                              gates=gates)
        k3 += kernels.LAUNCHES['bucket_precond'] - before
        nu = dk.last_nu
        if rank != 0:
            continue
        want = ref.precondition(ref_state, dict(grads), damping, lr,
                                gates=gates)
        errors[label] = {
            'precond': max(_tensor_rel(out[k], want[k]) for k in want),
            'nu': abs(float(nu) / float(ref.last_nu) - 1.0)}
        gated = {n for k in off for n in buckets[k]}
        for name, t in out.items():
            if name.rsplit('.', 1)[0] in gated and not torch.equal(
                    t, nu * grads[name]):
                report['failures'].append(f'{label}: {name} is not the raw '
                                          'gradient times nu')
        if errors[label]['precond'] > STEP_TOL['precond'] or \
                errors[label]['nu'] > STEP_TOL['nu']:
            report['failures'].append(f'{label}: {errors[label]}')
    report.update(errors=errors, gated_k3=k3,
                  launches=dict(kernels.LAUNCHES))
    Path(cfg['out']).write_text(json.dumps(report))
    dist.barrier()
    return 1 if report['failures'] else 0


def run_shards_gloo_world(card: str) -> dict:
    """Phase 43: GLOO_WORLD ranks of :func:`shards_dist_worker` on the
    card (2 slices of 2); then, in this process: one shard per rank with
    its rank and slice, a step record per step, the barrier probe's wait
    on the even steps only; the window heads labelled ``dcn_reduce`` in
    the rank-0 stream and every shard; the shards read by the port's
    ``merge_shards`` and ``straggler_summary`` (per-slice rows and the
    wait by stage class)."""
    import socket
    from distributed_kfac_pytorch_tpu_torch.observability import sink as \
        obs_sink
    from distributed_kfac_pytorch_tpu_torch.observability import \
        stragglers
    t0 = time.perf_counter()
    stream = _fresh_store('shards_resnet32.jsonl')
    for old in stream.parent.glob(stream.name + '*'):
        old.unlink()
    outs = [_fresh_store(f'shards_rank{r}.json') for r in range(GLOO_WORLD)]
    with _PORTS_LOCK:
        port = 0
        while port == 0 or port in _PORTS_TAKEN:
            with socket.socket() as s:
                s.bind(('localhost', 0))
                port = s.getsockname()[1]
        _PORTS_TAKEN.add(port)
    procs = []
    for rank in range(GLOO_WORLD):
        cfg = json.dumps({'phase': 'resnet32_shards', 'stream': str(stream),
                          'out': str(outs[rank])})
        env = {**{k: v for k, v in os.environ.items()
                  if k != 'KFAC_CHAOS'},
               'RANK': str(rank), 'WORLD_SIZE': str(GLOO_WORLD),
               'LOCAL_RANK': '0', 'MASTER_ADDR': 'localhost',
               'MASTER_PORT': str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / 'chip_smoke.py'), '--dist-worker',
             cfg], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = [json.loads(o.read_text()) if o.exists() else None
               for o in outs]
    for rank, (p, rep) in enumerate(zip(procs, reports)):
        if p.returncode != 0 or rep is None:
            log(logs[rank][-4000:])
            raise AssertionError(
                f'phase 43 rank {rank}: exit {p.returncode}; '
                f'{rep["failures"] if rep else "no report"}')
    problems = []
    main = [r for r in obs_sink.read_jsonl(str(stream))
            if r['kind'] == 'step']
    fired = [r.get('fired') for r in main]
    if fired[0::2] != ['inverse+dcn_reduce'] * (SHARDS_STEPS // 2):
        problems.append(f'window heads {fired}')
    shards, torn, errors = stragglers.merge_shards(str(stream))
    if sorted(shards) != list(range(GLOO_WORLD)) or torn or errors:
        problems.append(f'shards {sorted(shards)}, torn {torn}, {errors}')
    waits = {}
    for rank, records in shards.items():
        meta = [r['meta'] for r in records if r['kind'] == 'meta'][0]
        steps = [r for r in records if r['kind'] == 'step']
        waited = [r['step'] for r in steps
                  if stragglers.BARRIER_WAIT_KEY in r['metrics']]
        waits[rank] = [r['metrics'][stragglers.BARRIER_WAIT_KEY]
                       for r in steps if r['step'] in waited]
        if meta['rank'] != rank or meta['slice'] != rank // 2 \
                or [r['step'] for r in steps] != list(range(SHARDS_STEPS)) \
                or waited != list(range(0, SHARDS_STEPS, 2)) \
                or [r.get('fired') for r in steps] != fired:
            problems.append(f'rank {rank} shard: meta {meta}, steps '
                            f'{[r["step"] for r in steps]}, waits at '
                            f'{waited}')
    summary = stragglers.straggler_summary(shards)
    if summary is None or sorted(summary['per_slice']) != [0, 1] \
            or 'dcn' not in summary['wait_by_stage']:
        problems.append(f'summary {summary}')
    if problems:
        raise AssertionError('phase 43: ' + '; '.join(problems))
    total = {}
    for rep in reports:
        for k, v in rep['launches'].items():
            total[k] = total.get(k, 0) + v
    out = {'launches': total, 'errors': reports[0]['errors'],
           'gated_k3_per_rank': [r['gated_k3'] for r in reports],
           'waits_ms': waits, 'fired': fired, 'summary': summary,
           'losses': reports[0]['losses'],
           'seconds': time.perf_counter() - t0}
    log(f'  {GLOO_WORLD} ranks, 2 slices, {SHARDS_STEPS} steps: fired {fired}; '
        f'one shard per rank, barrier waits on steps 0 and 2 only (ms, by '
        f'rank) { {r: [round(w, 3) for w in v] for r, v in waits.items()} }')
    log(f'  straggler summary: wait by stage '
        f'{ {k: round(v["mean_wait_ms"], 3) for k, v in summary["wait_by_stage"].items()} }'
        f' ms, slices {sorted(summary["per_slice"])}')
    log(f'  gated precondition on the grid against the single device: '
        f'{reports[0]["errors"]}; K3 launches per rank '
        f'{out["gated_k3_per_rank"]}; all ranks: launches {total}')
    log(f'  phase 43: {out["seconds"]:.1f} s wall ({card})')
    return out


def run_observability_phases(card: str) -> dict:
    """Phase 41, then phases 42 and 43 at once (43's ranks are
    subprocesses: the in-process launch counts stay phase 42's own)."""
    log(f'== phase 41: observability on ResNet-50 through the ImageNet CLI, '
        f'224 px, batch {R50_BATCH}, auto, {OBS_STEPS} steps, --profile-dir '
        f'--memory-interval {OBS_MEMORY_EVERY} on and off')
    out = {'observability': run_observability_phase(card)}
    log('== phases 42 and 43 at once: self-healing on ResNet-32 through the '
        'CIFAR CLI (diverge, corrupt-factor, armed without a fault, '
        f'unarmed); straggler shards, {GLOO_WORLD} gloo ranks of ResNet-32 '
        'on the card, 2 slices, hierarchical reduce (their lines in that '
        'order)')
    out['selfheal'], out['shards_gloo_world'] = at_once(
        (run_selfheal_phase, card), (run_shards_gloo_world, card),
        here=True)
    return out


def _category(name: str) -> str:
    """Coarse owner of a CUDA kernel, from its (mangled) name."""
    n = name.lower()
    if 'factor_partial' in n or 'factor_finalize' in n:
        return 'K1 factor_ema'
    if 'patch_partial' in n or 'patch_finalize' in n:
        return 'K2 patch_cov'
    if 'bgemm_kernel' in n or 'vg_reduce' in n:
        return 'K3 bucket_precond'
    if any(f'ns_{k}_kernel' in n
           for k in ('fold', 'init', 'residual', 'update', 'finish')):
        return 'K4 ns_inverse'
    if any(f'jacobi_{k}' in n for k in ('round', 'cluster', 'vlog')):
        return 'K5 jacobi_eigh'
    if 'conv' in n or 'cudnn' in n or 'implicit_gemm' in n or 'wgrad' in n \
            or 'dgrad' in n:
        return 'model convolutions (cuDNN)'
    if any(k in n for k in ('potrf', 'trsm', 'cusolver', 'syrk', 'trsv')):
        return 'factorizations (cuSOLVER: Cholesky, triangular solves)'
    if 'gemm' in n or 'cutlass' in n or 'sm90_' in n or 'gemv' in n:
        return 'matmul (cuBLAS: layers, factors, warm polish)'
    if 'batch_norm' in n or 'bn_' in n:
        return 'batch norm'
    if 'reduce' in n:
        return 'reductions'
    return 'elementwise / copies / other'


def profile_main_path(which: str = 'resnet32', steps: int = 5,
                      **xl_over) -> dict:
    """torch.profiler over ``steps`` steady non-firing steps and one firing
    step of the ResNet-32 path, the ResNet-50 ``newton`` path, the LSTM
    LM ``jacobi`` path, the Transformer-XL path of phase 15 or phase 23's
    config 5 with bf16 or fp32 factors, or ViT-S/16 at phase 33's shapes
    (``which``: 'resnet32', 'resnet50', 'lstm', 'transformer_xl',
    'resnet152', 'resnet152_fp32', 'vit_small'; 'resnet50_fp16' and
    'transformer_xl_fp16' under ``--fp16``'s compute dtype and dynamic
    loss scale, 'vit_small_bf16' at bf16 activations; ``xl_over``: LM CLI
    options over phase 15's): device time by kernel category and the
    device's busy share (kernel time / wall time of the profiled
    window)."""
    import functools
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_kfac_pytorch_tpu_torch import fp16, \
        train_language_model
    from distributed_kfac_pytorch_tpu_torch.models import cifar_resnet, \
        imagenet_resnet, lstm_lm, vit
    from distributed_kfac_pytorch_tpu_torch.training import datasets, \
        engine, optimizers, utils
    dev = torch.device('cuda')
    gen = None
    half = which.endswith('_fp16')
    if half:
        which = which[:-len('_fp16')]
        xl_over = {**xl_over, 'fp16': True}
    lm = which in ('lstm', 'transformer_xl')
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if which.startswith('vit_small'):
            x, y = _fixed_batch(VIT_BATCH, VIT_PX, dev)
            model = vit.get_model(1000, 'small', image_size=VIT_PX, dtype=(
                torch.bfloat16 if which.endswith('bf16')
                else torch.float32)).to(dev)
            cfg = optimizers.OptimConfig(
                base_lr=0.1, weight_decay=5e-5, damping=0.003,
                kfac_inv_update_freq=10, kfac_cov_update_freq=1)
            criterion = torch.nn.functional.cross_entropy
        elif which == 'transformer_xl':
            args = engine.parse_args(train_language_model.build_parser(),
                                     _xl_config(**xl_over))
            x, y = _xl_first_window()
            model = train_language_model.build_model(args, XL_VOCAB, dev)
            cfg = optimizers.OptimConfig(
                base_lr=1.0, weight_decay=0.0, lr_decay=(20, 30),
                kfac_inv_update_freq=10, kfac_cov_update_freq=1)
            criterion = None
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        elif which == 'lstm':
            ids, _, vocab = datasets.get_lm_corpus(vocab_size=10000)
            x, y = next(datasets.bptt_batches(ids, 20, 35))
            model = lstm_lm.LSTMLanguageModel(vocab).to(dev)
            cfg = optimizers.OptimConfig(
                base_lr=1.0, weight_decay=0.0, lr_decay=(20, 30),
                inverse_method='eigen', eigh_method='jacobi',
                kfac_inv_update_freq=10, kfac_cov_update_freq=1,
                skip_layers=('embed', 'decoder'))
            criterion = None
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        elif which == 'resnet50':
            (x, y), _ = datasets.get_imagenet(synthetic_size=R50_BATCH)
            model = imagenet_resnet.get_model('resnet50', dtype=(
                torch.float16 if half else torch.float32)).to(dev)
            cfg = optimizers.OptimConfig(
                base_lr=R50_LR, weight_decay=5e-5, damping=0.001,
                inverse_method='newton', kfac_inv_update_freq=10,
                kfac_cov_update_freq=1)
            criterion = functools.partial(utils.label_smooth_loss,
                                          smoothing=0.1)
        elif which in ('resnet152', 'resnet152_fp32'):
            (x, y), _ = datasets.get_imagenet(synthetic_size=R50_BATCH)
            model = imagenet_resnet.get_model('resnet152').to(dev)
            cfg = optimizers.OptimConfig(
                base_lr=R152_LR, weight_decay=5e-5, damping=0.001,
                inverse_method='eigen', kfac_inv_update_freq=10,
                kfac_cov_update_freq=1,
                bf16_factors=which == 'resnet152')
            criterion = functools.partial(utils.label_smooth_loss,
                                          smoothing=0.1)
        else:
            (x, y), _ = datasets.get_cifar(synthetic_size=128)
            model = cifar_resnet.get_model('resnet32').to(dev)
            cfg = optimizers.OptimConfig(kfac_inv_update_freq=10,
                                         kfac_cov_update_freq=1)
            criterion = torch.nn.functional.cross_entropy
    optimizer, _, kfac, sched = optimizers.get_optimizer(model, cfg, dev)
    state = engine.TrainState(
        model=model, optimizer=optimizer, kfac=kfac,
        kfac_state=kfac.init_state(),
        loss_scale=fp16.init_loss_scale(device=dev) if half else None)
    hyper = {'lr': cfg.base_lr, **sched.params()}
    xb = torch.as_tensor(x, device=dev)
    yb = torch.as_tensor(y, device=dev)

    def step():
        flags = engine.cadence_flags(state.step, 1, 10)
        if lm:
            engine.lm_train_step(state, xb.long(), yb.long(), hyper, flags,
                                 grad_clip=0.25, generator=gen)
        else:
            engine.train_step(state, xb, yb, hyper, flags, criterion)
        state.step += 1

    while state.step < 11:            # warm-up, incl. the firings at 0, 10
        step()
    torch.cuda.synchronize()
    out = {}
    for label, n in (('non_firing', steps), ('firing', 1)):
        if label == 'firing':
            while state.step % 10:
                step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        cats: dict[str, float] = {}
        k5: dict[str, float] = {}
        other: dict[str, float] = {}
        kernels_ms = 0.0
        for ev in prof.key_averages():
            dt = getattr(ev, 'self_device_time_total', None)
            if dt is None:
                dt = ev.self_cuda_time_total
            if not dt or ev.device_type.name != 'CUDA':
                continue
            ms = dt / 1e3 / n
            cats[_category(ev.key)] = cats.get(_category(ev.key), 0.0) + ms
            if _category(ev.key).startswith('elementwise'):
                other[ev.key[:90]] = other.get(ev.key[:90], 0.0) + ms
            kernels_ms += ms
            for part in ('round', 'cluster', 'vlog'):
                if f'jacobi_{part}' in ev.key:
                    k5[part] = k5.get(part, 0.0) + ms
        out[label] = {'wall_ms_per_step': wall_ms,
                      'device_kernel_ms_per_step': kernels_ms,
                      'device_busy_share': kernels_ms / wall_ms,
                      'by_category_ms': dict(sorted(
                          cats.items(), key=lambda kv: -kv[1])),
                      'k5_by_kernel_ms': k5,
                      'elementwise_top_ms': dict(sorted(
                          other.items(), key=lambda kv: -kv[1])[:12])}
        log(f'  {label}: wall {wall_ms:.2f} ms/step, device kernels '
            f'{kernels_ms:.2f} ms/step, busy {kernels_ms / wall_ms:.1%}')
        for cat, ms in out[label]['by_category_ms'].items():
            log(f'    {cat:45s} {ms:8.3f} ms')
        for key, ms in list(out[label]['elementwise_top_ms'].items())[:8]:
            log(f'      elementwise: {key[:70]:70s} {ms:8.3f} ms')
        if k5:
            log('    K5 by kernel (round: streaming, cluster: A, vlog: V): '
                + ', '.join(f'{k} {ms:.3f} ms' for k, ms in k5.items()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--quick', action='store_true',
                    help='build verbosely and check the kernels only')
    ap.add_argument('--profile', action='store_true',
                    help='also profile steady main-path steps')
    ap.add_argument('--resume-only', action='store_true',
                    help='build, then run phases 27-28 only (no result '
                         'line)')
    ap.add_argument('--accum-only', action='store_true',
                    help='build, then run phases 29-31 only (no result '
                         'line)')
    ap.add_argument('--models-only', action='store_true',
                    help="build, then run phase 3's ViT-S and MobileNetV1 "
                         'cases and phases 32-33 only (no result line)')
    ap.add_argument('--fp16-only', action='store_true',
                    help="build, then run phase 3's fp16 ResNet-50 cases "
                         'and phases 34-36 only (no result line)')
    ap.add_argument('--lowrank-only', action='store_true',
                    help='build, then run phases 37-39 only (no result '
                         'line)')
    ap.add_argument('--metrics-only', action='store_true',
                    help="build, then run phase 40 and phase 14's gloo "
                         'world only (no result line)')
    ap.add_argument('--observability-only', action='store_true',
                    help='build, then run phases 41-43 only (no result '
                         'line)')
    ap.add_argument('--determinism-probe', action='store_true',
                    help="build, then measure what phase 27's "
                         '--deterministic buys and costs (no result '
                         'line; with --resume-only, before phases 27-28)')
    ap.add_argument('--dist-worker', metavar='CONFIG',
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if args.dist_worker:
        sys.path.insert(0, str(ROOT))
        cfg = json.loads(args.dist_worker)
        return {'lm': lm_dist_worker, 'seq': seq_dist_worker,
                'resnet32_overlap': overlap_dist_worker,
                'resnet32_slices': slice_dist_worker,
                'resnet32_shards': shards_dist_worker,
                'resnet32gn_accum': accum_dist_worker}.get(
            cfg['phase'], dist_worker)(cfg)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_kfac_pytorch_tpu_torch import set_fp32_precision
    from distributed_kfac_pytorch_tpu_torch.ops import kernels

    set_fp32_precision()
    card = card_line()
    log('== environment')
    log(f'  {card}')
    log(f'  host {platform.node()}: {os.cpu_count()} CPUs, {_cpu_model()}')
    log(f'  torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'python {sys.version.split()[0]}, device '
        f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}')
    log(f'  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, '
        f'cudnn {torch.backends.cudnn.allow_tf32}')

    log('== build')
    t0 = time.perf_counter()
    paths = kernels.build(verbose=args.quick)
    log(f'  built {sorted(p.name for p in paths.values())} in '
        f'{time.perf_counter() - t0:.1f} s')

    if args.accum_only:
        report = {'card': card, **run_accum_phases(card)}
        out_dir = ROOT / 'chiprun_out'
        out_dir.mkdir(exist_ok=True)
        (out_dir / 'chip_smoke_accum.json').write_text(
            json.dumps(report, indent=1))
        log('done')
        return 0
    if args.fp16_only:
        log("== kernels K1, K2 vs plain versions: the ResNet-50 --fp16 "
            "step's own captures")
        report = {'card': card, 'fp16_inputs': check_fp16_inputs(card)}
        report.update(run_fp16_phases(card, {}))
        out_dir = ROOT / 'chiprun_out'
        out_dir.mkdir(exist_ok=True)
        (out_dir / 'chip_smoke_fp16.json').write_text(
            json.dumps(report, indent=1))
        log('done')
        return 0
    if args.lowrank_only:
        report = {'card': card, **run_lowrank_phases(card, {})}
        log(f'== phase 37\'s eigen run: {LOWRANK_XL_EIGEN_STEPS} steps')
        report['transformer_xl_lowrank_eigen'] = \
            run_transformer_xl_lowrank_eigen(card)
        log(f'== phase 39: {SLICE_COUNT} slices x 2 gloo ranks of ResNet-32 '
            'on the card')
        report['slice_gloo_world'] = run_slice_gloo_world(card)
        out_dir = ROOT / 'chiprun_out'
        out_dir.mkdir(exist_ok=True)
        (out_dir / 'chip_smoke_lowrank.json').write_text(
            json.dumps(report, indent=1))
        log('done')
        return 0
    if args.metrics_only:
        log(f'== phase 40: the K-FAC metrics stream, ResNet-50 through the '
            f'ImageNet CLI, 224 px, batch {R50_BATCH}, auto, '
            f'{METRICS_STEPS} steps, metrics on and off')
        report = {'card': card, 'metrics_stream': run_metrics_phase(card)}
        log(f'== phase 14: {GLOO_WORLD} gloo ranks of ResNet-32 on the card, '
            'the metrics on')
        report['gloo_world'] = run_gloo_world(card)
        out_dir = ROOT / 'chiprun_out'
        out_dir.mkdir(exist_ok=True)
        (out_dir / 'chip_smoke_metrics.json').write_text(
            json.dumps(report, indent=1))
        log('done')
        return 0
    if args.observability_only:
        report = {'card': card, **run_observability_phases(card)}
        out_dir = ROOT / 'chiprun_out'
        out_dir.mkdir(exist_ok=True)
        (out_dir / 'chip_smoke_observability.json').write_text(
            json.dumps(report, indent=1))
        log('done')
        return 0
    if args.models_only:
        report = {'card': card}
        for label, key, kw in _MODEL_KERNEL_CHECKS:
            log(label)
            report[f'per_step_{key}'], report[f'cases_{key}'] = \
                check_kernels(False, **kw)
        report.update(run_model_phases(card))
        out_dir = ROOT / 'chiprun_out'
        out_dir.mkdir(exist_ok=True)
        (out_dir / 'chip_smoke_models.json').write_text(
            json.dumps(report, indent=1))
        log('done')
        return 0
    if args.resume_only or args.determinism_probe:
        report = {'card': card}
        if args.determinism_probe:
            log('== --deterministic at phase 27: two runs without it, and '
                "phase 6's step time with cuDNN's deterministic algorithms "
                'off and on')
            report['determinism_probe'] = run_determinism_probe(card)
        if args.resume_only:
            report.update(run_resume_phases(card))
        out_dir = ROOT / 'chiprun_out'
        out_dir.mkdir(exist_ok=True)
        (out_dir / 'chip_smoke_resume.json').write_text(
            json.dumps(report, indent=1))
        log('done')
        return 0
    log('== kernels K1-K3 vs plain versions: ResNet-32 shapes')
    summary32, details = check_kernels(args.quick)
    log('== kernels K1-K3 vs plain versions: ResNet-50 shapes')
    summary50, details50 = check_kernels(args.quick, resnet50_shapes())
    log("== kernels K1, K2 vs plain versions: the ResNet-50 --fp16 step's "
        'own captures')
    fp16_inputs = check_fp16_inputs(card)
    log('== kernel K3 vs plain version: LSTM LM bucket')
    summary_lm, details_lm = check_kernels(args.quick, lstm=True)
    log('== kernels K1, K3 vs plain versions: Transformer-XL shapes')
    summary_xl, details_xl = check_kernels(args.quick, xl=True)
    log('== kernels K1-K3 vs plain versions: ResNet-152 shapes, config 5 '
        '(K1 bf16 storage, K1 and K2 bf16 multiplicands, K3 eigen and fed '
        'bf16 stacks)')
    r152 = resnet_shapes('resnet152')
    summary152, details152 = check_kernels(args.quick, r152, config5=True)
    model_checks = {}
    for label, key, kw in _MODEL_KERNEL_CHECKS:
        log(label)
        model_checks[key] = check_kernels(args.quick, **kw)
    log('== kernel K4 (Newton-Schulz inverse) vs plain version')
    summary_ns, details_ns = check_ns_inverse(args.quick)
    log('== kernel K5 (Jacobi eigh) vs plain version')
    summary_jac, summary_jac32, details_jac, jac_edges = check_jacobi_eigh(
        args.quick, defer_edges=not args.quick)
    report = {'card': card,
              'kernel_cases': (details + details50 + details_lm
                               + details_xl + details152
                               + model_checks['vit_small'][1]
                               + model_checks['mobilenet_v1'][1]
                               + details_ns + details_jac),
              'per_step_vit_small': model_checks['vit_small'][0],
              'per_step_mobilenet_v1': model_checks['mobilenet_v1'][0],
              'per_step_resnet32': summary32,
              'per_step_resnet50': summary50,
              'per_step_lstm': summary_lm,
              'per_step_transformer_xl': summary_xl,
              'per_step_resnet152_config5': summary152,
              'per_firing_resnet50_ns_inverse': summary_ns,
              'per_firing_lstm_jacobi_eigh': summary_jac,
              'per_firing_resnet32_jacobi_eigh': summary_jac32,
              'fp16_inputs': fp16_inputs}
    if not args.quick:
        log('== main path: ResNet-32, batch 128, '
            f'{STEPS} K-FAC steps on one batch')
        main_summary, res = run_main_path()
        log(f'  steady ms/step: non-firing '
            f'{main_summary["nonfiring_ms_median"]:.2f}, firing '
            f'{main_summary["firing_ms_median"]:.2f} ({card})')
        report['main_path'] = main_summary
        report['step_ms'] = res['step_ms']
        report['fired'] = res['fired']
        log(f'== main path: ResNet-50, 224 px, batch {R50_BATCH}, '
            f'inverse_method newton, {R50_STEPS} steps on one batch')
        r50, res50 = run_resnet50_newton(card)
        report['resnet50_newton'] = r50
        log('== ResNet-50, inverse_method auto, 3 steps')
        report['resnet50_auto'] = run_resnet50_auto(card)
        log('== main path: LSTM LM (PTB medium), batch 20, BPTT 35, '
            f'eigen + jacobi, {LM_STEPS} steps on one batch')
        report['lstm_jacobi'] = run_lstm_jacobi(card)
        log('== LSTM LM, CLI defaults (auto: Cholesky), 3 steps')
        report['lm_defaults'] = run_lm_defaults(card)
        log(f'== ResNet-32, eigh_method jacobi, {R32_JACOBI_STEPS} steps')
        report['resnet32_jacobi'] = run_resnet32_jacobi(card)
        log(f'== distributed: ResNet-50 as phase 6 in a one-rank NCCL '
            f'group, comm-opt, {R50_STEPS} steps')
        report['resnet50_nccl_world1'] = run_resnet50_nccl(card, r50)
        log(f'== phase 14, phase 31\'s world and phase 39 at once, each '
            f'{GLOO_WORLD} gloo ranks of ResNet-32 on the card, and phase '
            f'37\'s eigen run ({LOWRANK_XL_EIGEN_STEPS} XL steps) beside them '
            '(their lines in that order; phases 24 and 26 run after phase '
            '28, beside phase 27)')
        (report['gloo_world'], accum_world, report['slice_gloo_world'],
         report['transformer_xl_lowrank_eigen']) = at_once(
            (run_gloo_world, card), (run_accum_gloo_world, card),
            (run_slice_gloo_world, card),
            (run_transformer_xl_lowrank_eigen, card))
        log(f'== main path: Transformer-XL LM (d {XL_D}, {XL_LAYERS} blocks, '
            f'vocabulary {XL_VOCAB}, tied), BPTT {XL_BPTT}, batch '
            f'{XL_BATCH}, auto, {XL_STEPS} steps on one batch')
        report['transformer_xl'] = run_transformer_xl(card)
        log(f'== Transformer-XL LM, --kfac-approx reduce (tied statistics), '
            f'{XL_REDUCE_STEPS} steps')
        report['transformer_xl_reduce'] = run_transformer_xl_reduce(card)
        log(f'== Transformer-XL LM, --inverse-method newton, '
            f'{XL_NEWTON_STEPS} steps')
        report['transformer_xl_newton'], summary_ns_xl = \
            run_transformer_xl_newton(card)
        log(f'== Transformer LM, CLI defaults, {TLM_DEFAULT_STEPS} steps')
        report['transformer_defaults'] = run_transformer_defaults(card)
        log(f'== distributed: the Transformer-XL LM as phase 15 in a '
            f'one-rank NCCL group, comm-opt, {XL_STEPS} steps; shared '
            f'inputs at {XL_SHARED_LAYERS} blocks')
        report['transformer_xl_nccl_world1'] = run_transformer_xl_nccl(
            card, report['transformer_xl'])
        log(f'== the chunked attention fold: attention alone at '
            f'{ATTN_SHAPE}, block {ATTN_BLOCK}; phase 15 under '
            f'--attn-block-size {XL_ATTN_BLOCK}, {XL_STEPS} steps')
        report['transformer_xl_chunked'] = run_transformer_xl_chunked(
            card, report['transformer_xl'])
        log(f'== phases 20 and 22 at once, each {GLOO_WORLD} gloo ranks on '
            'the card, and phase 8\'s K5 edge cases (in that order)')
        report['lm_gloo_world'], report['seq_gloo_world'], edge_rows = \
            at_once((run_lm_gloo_world, card), (run_seq_gloo_world, card),
                    (check_jacobi_edges, jac_edges))
        report['kernel_cases'] += edge_rows
        del jac_edges
        log(f'== tracked config 5: ResNet-152, 224 px, batch {R50_BATCH}, '
            f'--bf16-factors --inverse-method eigen, {R152_STEPS} steps on '
            f'one batch; {R152_SHORT_STEPS} steps with fp32 factors and with '
            'the three bf16 flags; the Transformer-XL LM with the three '
            f'flags, {R152_SHORT_STEPS} steps')
        report['resnet152_config5'] = run_resnet152_config5(
            card, r152, report['transformer_xl'])
        log(f'== the firing schedule at config 5: {SCHEDULE_CHUNKS} chunks, '
            f'{SCHEDULE_STEPS} steps; with --inv-staleness 1; ResNet-50 '
            f'newton in chunks; --factor-batch-fraction {FRACTION}, '
            f'{R152_SHORT_STEPS} steps; the Transformer-XL LM with '
            '--inv-pipeline-chunks 2 --deferred-factor-reduction, one device '
            'and a one-rank NCCL group')
        report['firing_schedule'] = run_firing_schedule(
            card, r152, report['resnet152_config5'],
            {k: summary152[k]['ms'] for k in ('factor_ema', 'patch_cov')})
        resume = run_resume_phases(card, after_28=(
            (run_overlap_gloo_world, card), (run_bf16_gloo_world, card)))
        report['overlap_gloo_world'], report['bf16_gloo_world'] = \
            resume.pop('after_28')
        report.update(resume)
        report.update(run_accum_phases(card, accum_world))
        report.update(run_model_phases(card))
        report.update(run_fp16_phases(card, report))
        report.update(run_lowrank_phases(card, report))
        log(f'== phase 40: the K-FAC metrics stream, ResNet-50 through the '
            f'ImageNet CLI, 224 px, batch {R50_BATCH}, auto, '
            f'{METRICS_STEPS} steps, metrics on and off')
        report['metrics_stream'] = run_metrics_phase(card)
        report.update(run_observability_phases(card))
        runs = (main_summary, r50, report['resnet50_auto'],
                report['lstm_jacobi'], report['lm_defaults'],
                report['resnet32_jacobi'], report['resnet50_nccl_world1'],
                report['gloo_world'], report['transformer_xl'],
                report['transformer_xl_reduce'],
                report['transformer_xl_newton'],
                report['transformer_defaults'],
                report['transformer_xl_nccl_world1'],
                report['lm_gloo_world'], report['transformer_xl_chunked'],
                report['seq_gloo_world'], report['resnet152_config5'],
                report['bf16_gloo_world'], report['firing_schedule'],
                report['overlap_gloo_world'], report['resume_resnet50'],
                report['resume_gloo_world'], report['grad_accum'],
                report['remat'], report['precise_bn'],
                report['accum_gloo_world'], report['mobilenet'],
                report['vit'], report['resnet50_fp16'],
                report['transformer_xl_fp16'], report['bf16_models'],
                report['slice_gloo_world'], report['transformer_xl_lowrank'],
                report['transformer_xl_lowrank_eigen'],
                report['resnet152_lowrank'], report['metrics_stream'],
                report['observability'], report['selfheal'],
                report['shards_gloo_world'])
        launches = {name: sum(r['launches'].get(name, 0) for r in runs)
                    for name in kernels.LAUNCHES}
        aggs = {**summary50, 'ns_inverse': summary_ns,
                'jacobi_eigh': summary_jac}
        line = []
        for name in kernels.LAUNCHES:
            agg = aggs[name]
            t_bytes, t_ops = agg['t_bytes'], agg['t_ops']
            entry = {
                'name': name, 'route': 'cuda',
                'source': kernels.KERNEL_INFO[name]['source'],
                'replaces': kernels.KERNEL_INFO[name]['replaces'],
                'launches': launches[name],
                'max_abs_err': agg['max_abs_err'],
                'ms': agg['ms'], 'plain_ms': agg['plain_ms'],
                'bound_ms': max(t_bytes, t_ops),
                'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
                'library_ms': agg['library_ms'],
                'bound_rate': BOUND_RATE.get(name, FP32_RATE)}
            if name in TC_KERNELS:
                entry['fp32_bound_ms'] = agg['fp32_bound_ms']
            # K1 and K3 per Transformer-XL step, K4 per XL firing.
            xl_agg, xl_launches = (
                (summary_xl.get(name), report['transformer_xl']['launches'])
                if name != 'ns_inverse' else
                (summary_ns_xl, report['transformer_xl_newton']['launches']))
            if xl_agg and xl_launches.get(name):
                t_b, t_o = xl_agg['t_bytes'], xl_agg['t_ops']
                entry['transformer_xl'] = {
                    'per': 'firing' if name == 'ns_inverse' else 'step',
                    'launches': xl_launches[name],
                    'max_abs_err': xl_agg['max_abs_err'],
                    'ms': xl_agg['ms'], 'plain_ms': xl_agg['plain_ms'],
                    'bound_ms': max(t_b, t_o),
                    'bound_by': 'bytes' if t_b >= t_o else 'operations',
                    'library_ms': xl_agg['library_ms'],
                    'fp32_bound_ms': xl_agg['fp32_bound_ms']}
            # K1-K3 per config-5 step (ResNet-152, bf16 factors).
            agg152 = summary152.get(name)
            if agg152:
                t_b, t_o = agg152['t_bytes'], agg152['t_ops']
                entry['resnet152_config5'] = {
                    'per': 'step', 'launches': report['resnet152_config5'][
                        'bf16_factors']['launches'][name],
                    'max_abs_err': agg152['max_abs_err'],
                    'ms': agg152['ms'], 'plain_ms': agg152['plain_ms'],
                    'bound_ms': max(t_b, t_o),
                    'bound_by': 'bytes' if t_b >= t_o else 'operations',
                    'library_ms': agg152['library_ms'],
                    'fp32_bound_ms': agg152['fp32_bound_ms']}
            # K1-K3 per ViT-S/16 step (phase 33, 'auto') and per
            # MobileNetV1 step (phase 32).
            for key, per_step in (('vit_small', VIT_PER_STEP),
                                  ('mobilenet_v1', MB_PER_STEP)):
                agg_m = model_checks[key][0].get(name)
                if agg_m:
                    t_b, t_o = agg_m['t_bytes'], agg_m['t_ops']
                    entry[key] = {
                        'per': 'step', 'launches': per_step[name],
                        'max_abs_err': agg_m['max_abs_err'],
                        'ms': agg_m['ms'], 'plain_ms': agg_m['plain_ms'],
                        'bound_ms': max(t_b, t_o),
                        'bound_by': 'bytes' if t_b >= t_o else 'operations',
                        'library_ms': agg_m['library_ms'],
                        'fp32_bound_ms': agg_m['fp32_bound_ms']}
            # K1 and K2 per ResNet-50 --fp16 step, on its own captures.
            agg16 = fp16_inputs.get(name)
            if agg16:
                entry['resnet50_fp16'] = {
                    'per': 'step', 'launches': agg16['launches'],
                    'input_dtypes': agg16['input_dtypes'],
                    **{k: agg16[k] for k in (
                        'max_abs_err', 'ms', 'fp32_input_ms', 'plain_ms',
                        'bound_ms', 'bound_by', 'library_ms')}}
            line.append(entry)
        report['kernels'] = line
        report['phase_walls'] = phase_walls()
        log('  phase walls, largest first: ' + '; '.join(
            f'{w} s {h}' for h, w in report['phase_walls'][:12]))
        if args.profile:
            log('== profile: device time by kernel category, ResNet-32')
            report['profile'] = profile_main_path()
            log('== profile: device time by kernel category, ResNet-50 '
                'newton')
            report['profile_resnet50'] = profile_main_path('resnet50')
            if not report['profile_resnet50']['non_firing'][
                    'by_category_ms'].get('K2 patch_cov'):
                raise AssertionError('profile: no K2 patch_cov device time '
                                     'in the ResNet-50 steps')
            log('== profile: device time by kernel category, LSTM LM '
                'jacobi')
            report['profile_lstm'] = profile_main_path('lstm')
            _release()
            log('== profile: device time by kernel category, '
                'Transformer-XL LM auto')
            report['profile_transformer_xl'] = profile_main_path(
                'transformer_xl')
            if not report['profile_transformer_xl']['non_firing'][
                    'by_category_ms'].get('K1 factor_ema'):
                raise AssertionError('profile: no K1 factor_ema device time '
                                     'in the Transformer-XL steps')
            for which, what in (('resnet152', 'bf16 factors'),
                                ('resnet152_fp32', 'fp32 factors')):
                _release()
                log('== profile: device time by kernel category, config 5 '
                    f'(ResNet-152, eigen) with {what}')
                report[f'profile_{which}'] = profile_main_path(which)
            for which in PROFILE_HALF:
                _release()
                log(f'== profile: device time by kernel category, {which}')
                report[f'profile_{which}'] = profile_main_path(which)
    out_dir = ROOT / 'chiprun_out'
    out_dir.mkdir(exist_ok=True)
    (out_dir / 'chip_smoke.json').write_text(json.dumps(report, indent=1))
    if args.quick:
        log('quick check passed')
        return 0
    log(card)
    log(json.dumps({'kernels': report['kernels']}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        code = main()
    except Exception:  # report and fail: no phase failure is swallowed
        traceback.print_exc()
        code = 1
    sys.exit(code)
