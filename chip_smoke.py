"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--coca-only | --siglip-only |
                                       --zoo-only | --pretrained-only |
                                       --dist-only | --tp-only |
                                       --tp-zoo-only | --fp16-only]
    python3 chip_smoke.py --clipa-batch-probe | --siglip-batch-probe |
                          --zoo-batch-probe

Drives the port's main paths at full width in bf16 with a seeded random
init, through the entry points a user calls: the XTag ViT-B-32
fusion-classify serving path (create_model, cast_for_compute, PromptTable,
precompute_prompt_features, make_xtag_serve_step), the XTag ViT-B-32
train step (create_model, make_optimizer, create_train_state,
make_train_step), the scar training CLI (main_other.main) and the predict
CLI (predict.main, with weights and its serving artifact); then the serve,
train and CLI paths and the serving artifact for the cls-free GAP tower
(XTag ViT-B-16 with the vision overrides image_size 256, pool_type avg,
no_class_token: L = 256, whose vision blocks run flash attention and the
fused MLP), in phases that each print one JSON line:

1. build: compiles the CUDA kernels of xtagclip_tpu_torch/csrc with nvcc,
   with ptxas's registers and spill bytes for every kernel entry;
2. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths give it (and, for flash attention, at edge
   shapes: L = 128, 197, 257, 384, head dim 128; ViT-H-14's head dim 80 at
   L = 257 and 37 and, for the 336 px eval, L = 577 at batch 64; and head
   dims 72, 88, 104, 112; the zoo's EVA02-L-14 and ViTamin-L-256 trainer
   shapes, EVA02-B-16's L = 197, EVA01-g's dh 88, EVA02-E's dh 112 and
   ViTamin-XL's dh 72 at L = 256 and 196); the 336 px eval's text halves without a mask at
   one zero-shot classifier chunk, 800 prompts of 32 tokens, and its 36928
   vision MLP rows), every output within atol = max|ref|/128 and
   rtol = 1e-2 (one bf16 ULP at output scale); the image normalize (kernel
   #5) within one bf16 ULP on every element, or 2^-22 for fp32 output, at
   the main path's batch, at a ragged odd-sized one, at the 336 px
   eval's 64 x 336 x 336 and at the baselines' 4 x 224 x 224; every
   kernel also at coca_ViT-L-14's shapes (its decoder's causal halves at
   B 128 x L 75 and generation's [8 or 48, 30] buffers, the MLP half at
   its decoder and text rows, ViT-L/14's flash attention and fused MLP at
   L = 257, the normalize at 128 x 224 x 224); flash attention forward
   and backward also under the causal mask (FLASH_MASK_CASES: 8 heads
   of 128 at L = 77, 16 of 64 at L = 256, 16 of 80 at L = 77) and at
   head dim 256 (8 x 4 heads at L = 256) without and with it; the device
   time of kernel and plain version (torch.profiler: the summed durations
   of the kernels one call runs, over 20 calls, so a wrapper whose host
   side outlasts its kernel is timed by its kernel, and the kernel's split
   by the kernels its wrapper launches;
   the median CUDA-event time of 10 back-to-back calls beside it), the same
   for one PyTorch call computing the same function where there is one
   (scaled_dot_product_attention for flash attention's forward; for its
   backward, SDPA's backward alone through autograd from a forward run
   outside the timing, and its forward + backward beside it; under the
   row's mask), and the card's least time for the same work; the fused attention half, its
   backward, the MLP half and flash attention's backward launched twice on
   the same inputs must give the same bits;
   Then flash_block: one ResidualAttentionBlock of width 1024 with 8
   heads of 128 under the causal mask at L = 77 (#6 with the mask, #4),
   forward and backward, kernels on against off at phase 6's bars;
3. serve: precompute every scar pseudo-prompt (3 classes x 2304 combos)
   twice, timing the cold and the warm pass (prompts/s is the warm one);
   then, after two warm-up batches, a timed window of 200 batches of 32
   seeded uint8 224x224 images (about 2 s on an H100): img/s is all the
   window's images over its wall time, latencies are over all its batches.
   Then decode_serve: 32 seeded 480 x 640 JPEGs through
   ``decode_square_batch`` (its route named), ``resize_crop_normalize`` on
   the card and the serve step, 1 + DECODE_REPS batches (decode img/s,
   end-to-end img/s, 12 + 12 forward halves a batch and no #5), the
   outputs against the plain halves' at phase 4's bars;
4. path: the kernel launches counted in phase 3 (12 of each forward half
   per serve batch and per precompute chunk), and the first 8 serve
   batches run again through the plain versions: fusion logits within
   5e-2, image-feature cosine >= 0.999, tag picks agreeing on >= 95% of
   (image, category) pairs, every output finite;
5. train: ViT-B-32 --use-tagging --use-fusion over fp32 master weights,
   the paper recipe's AdamW (lr 5e-5, wd 0.1, betas (0.9, 0.98), eps 1e-6,
   cosine schedule with warmup 50), batches of 32 seeded uint8 images
   normalized on the card, class ids, one tag per category, the scar
   prompt table and a seeded dropout generator: 3 warm-up steps, then a
   timed window of 30 steps (samples/s, p50/p90 step ms, losses,
   grad_norm), each step launching exactly 24 of each of the forward
   halves and 24 attention-half backward kernels (12 vision + 12 text).
   Then multi_step: ``make_multi_step`` of MULTI_STEPS steps over stacked
   batches against as many ``make_train_step`` calls on the same
   batches and generator seed: parameters, AdamW state and metrics bit
   for bit equal, launches per step as phase 5's, samples/s of one more
   call;
6. train path: one step from the same weights, batch and dropout seed
   with the kernels on and off (autograd through the plain halves and the
   plain normalize), on the batch's ground-truth prompts: loss within 1e-2
   relative, every parameter gradient that is nonzero on the plain side at
   cosine >= 0.99 or within its bf16 noise floor (see phase_train_path),
   global gradient norm within 2%;
7. trainer: ``main_other.main`` on seeded PNG files (256 train and 96 val
   rows of a scar split in the reference's layout), batch 32, 4 loader
   threads: 2 epochs of the plain step, each followed by the scar eval
   (val and train data) and the checkpoint policy (--save-best,
   --delete-previous-checkpoint), then a second call with --resume latest
   and --accum-freq 2 for a third epoch. It prints samples/s, p50 step ms
   and the loss per epoch, eval img/s, seconds per checkpoint save, the
   host ms of one loader item, and the launches per plain step, per
   accumulation step, per eval batch and per classifier build; it fails
   on a value that is not finite, a last plain epoch whose mean loss is
   not below the first's, a missing artifact or checkpoint, launches off
   their expected counts, or a reloaded state that differs in one bit;
8. gap_serve, gap_path, gap_train, gap_train_path: phases 3-6 for the GAP
   tower (batches of 32 seeded uint8 256x256 images), with the same bars;
   per serve batch 12 flash forwards, 12 fused MLPs and 1 normalize; per
   train step 12 flash forwards and backwards and 12 fused MLPs (vision),
   12 of each half and of the attention half's backward (text), 1
   normalize;
9. gap_trainer: one ``main_other.main`` call with ``--model`` naming the
   GAP config through XTAGCLIP_EXTRA_CONFIGS (a JSON written to a
   temporary directory): one plain epoch on 64 train and 32 val seeded
   272x272 PNG rows (crops 256), the scar eval and the checkpoints; it
   fails on a value that is not finite, a missing artifact or checkpoint,
   or launches off their expected counts;
10. predict (after the trainer): the phase-3 model written as an open_clip
   .pt (convert/export.py; reloaded bit for bit) and 70 seeded 224x224
   PNGs (batches 32, 32, 6), then ``predict.main`` five times:
   --pretrained --fusion-classify --export-serving (the torch.export
   artifact: encode_image, encode_text, forward, serve_classify), the same
   from the artifact (--serving-artifact: same classes and tags, probs
   within 0.05), the zero-shot head (--use-tagging, then --fusion-scoring)
   and --resume on the trainer's last tag (finite records, scar classes).
   Each call serves every batch from one CUDA graph: its first serve call
   launches one eager warm-up and one capture (twice one batch's
   launches), later calls launch nothing. The exported serve_classify
   holds 12 + 12 block-half and 1 normalize custom-op nodes. Then the
   serve step on uint8 batches on the card, captured and replayed against
   its eager calls (tag picks equal, features and logits within
   max|ref|/128; bit equality printed) and both timed over the serve
   window (200 batches of 32);
11. gap_predict: the GAP tower's serve_classify exported, loaded
   and replayed as a graph against the live eager step, with the same
   bars (12 flash attention, 12 fused MLP and 1 normalize node), both
   timed;
12. clipa: the CLIPA ViT-H/14 GAP recipe (BASELINE config 5:
   scripts/h14_84_8_pretrain.sh, scripts/h14_224_32_finetune.sh) through
   ``cli.main.main`` at full width and half depth (CLIPA_DEPTH_CUT: 16
   of the 32 vision blocks of width 1280, 16 heads of 80; 12 of the 24
   text blocks of width 1024; the published 986M parameters at full depth),
   --grad-checkpointing, batch 256 (not the scripts' 4096: one card's 80
   GB) and no --fsdp (one process), both stages reading 8 seeded tar
   shards of 224 (JPEG, caption) samples (--dataset-type webdataset):
   stage 1 (syntax-mask CL8 tokenizer, 84 px, L = 37, --native-decode)
   for 2 steps; stage 2 (CL32, 224 px, L = 257, squash, bilinear,
   ImageNet mean/std, the PIL decode) from stage 1's checkpoint for 2
   warm-up + 3 timed steps; ``evaluate`` on a CSV of 128 seeded PNGs. It
   prints samples/s, p50 step ms, each step's data wait, the decode route
   and the samples each route decoded, peak memory, checkpoint bytes and
   save seconds, eval img/s and metrics, and fails on launches off
   _clipa_per_step / _clipa_per_eval_batch, a value that is not finite,
   fewer samples decoded than the steps took or syntax-mask ids off the
   front-truncation fallback;
13. clipa_eval: scripts/clipav2_vit_h14_i84_224_336_cl32_gap_datacomp1b.sh's
   flags through ``cli.main.main`` at full width and half depth
   (ViT-H-14-CL32-GAP-BigVision, CLIPA_DEPTH_CUT, --force-image-size 336:
   L = 577): --pretrained a seeded big_vision .npz in the CLIPA-v2 layout
   (2.0 GB at half depth, 3.9 GB at full,
   written to a temporary directory and deleted), the BERT WordPiece
   tokenizer found as bert-base-uncased in a temporary HF_HUB_CACHE, and
   --imagenet-val a folder of 192 seeded JPEGs in 8 class directories: the
   load, the 1000 x 80-prompt zero-shot classifier and the eval, each
   timed; launches per classifier chunk and per eval batch asserted; one
   eval batch's image features and one classifier chunk's text features
   with the kernels on vs off at cosine >= 0.999; the archive keys the
   converter leaves unread and the parameters kept at their init printed
   and held to the list JAX's converter implies;
14. clipa_path: stage 2's model (half depth, as phase 12) at batch 32:
   one step with --grad-checkpointing on and off (loss and gradients bit
   for bit, peak
   memory of each), one with the kernels on and off (phase 6's bars), a
   kernels-on step at --force-patch-dropout 0.5 (finite), and eval image
   features kernels vs plain (cosine >= 0.999);
15. rn50: the CLIP RN50 tower (ModifiedResNet) in fp32 at batch 32 on the
   card against the CPU's forward on the same weights (within 1e-3 of the
   outputs' largest magnitude);
16. biomedclip_scar: BASELINE config 3 as scar_Biomedclip_pretrain.sh
   runs it, ``main_other.main`` with its flags (--lock-image --lock-text
   --use-tagging --precision amp --lr 5e-6 --wd 0.1 --warmup 50
   --prompt-template-setting sentence_1) at full width and depth, batch
   4, one epoch on 64 + 32 seeded scar rows, from a seeded open_clip-layout
   BiomedCLIP .pt (timm ViT-B/16 + PubMedBERT, 0.79 GB) and a 30522-id
   WordPiece vocabulary in a temporary HF_HUB_CACHE: the model built is
   BiomedCLIP, the locked towers bit-unchanged, one #5 launch per batch,
   losses and eval finite; prompt-table seconds, samples/s, p50 step ms,
   data wait, eval img/s and peak memory printed;
17. baselines (last): resnet50_baseline (from a seeded torchvision
   ResNet-50 .pth), clip_baseline (ViT-B-32, --lock-image) and
   biomedclip_baseline (the same .pt, with --lock-image
   --lock-text-encoder and with neither) through their ``main()`` on the
   card, 2 epochs of batch 4 in fp32: checkpoint, metrics, no fallback,
   one #5 launch per batch, the best epoch's eval logits within 1e-3 of
   the CPU's on the same weights (TF32 off); epoch seconds, samples/s and
   peak memory printed. The .pt is deleted after;
18. coca: coca_ViT-L-14 (638M parameters) in bf16 from a seeded init:
   ``models.coca.generate`` on 8 seeded images (seq_len 30) by top-k,
   top-p and grouped beam search at JAX's defaults, one warm-up and 3
   timed calls each (captions/s, p50 ms per batch, decoded captions,
   launches per call against the vision blocks once and the text tower
   and decoder per decoder step); one decoder step's logits kernels on vs
   off (see phase_coca) and the image encode at cosine >= 0.999;
19. coca_train: open_clip README's coca_ViT-L-14 MSCOCO fine-tune flags
   through ``cli.main.main`` at batch 128 on 896 seeded PNG + caption CSV
   rows (2 warm-up + 3 timed steps; samples/s, p50 step ms, peak memory,
   the checkpoint), evaluate on 256 more (eval img/s), launches per step
   and per eval batch asserted, and one step kernels on vs off at batch 32
   at phase 6's bars;
20. siglip: ViT-B-16-SigLIP (the config of open_clip's public webli
   weights) through ``cli.main --siglip`` at full width and depth from a
   seeded init, synthetic data with SigLIP's T5 tokenizer written to a
   temporary HF_HUB_CACHE, 2 warm-up + 3 timed steps of 256 (its text
   tower: #1, #2, #3; the timm MAP-pool vision tower plain, as JAX runs it
   through XLA), then ViT-SO400M-14-SigLIP for 1 + 3 steps at the largest
   batch that fits without checkpointing (its text tower: #6 at head dim
   72, #4 at 1152 -> 4304); samples/s, p50 step ms, peak memory, launches
   per step asserted, the logit bias moved from its init; one B-16 step
   kernels on vs off at batch 64 at phase 6's bars, logit_bias's gradient
   nonzero;
21. distill: open_clip README's distillation (--distill-model ViT-L-14
   --distill-pretrained) through ``cli.main``, student ViT-B-32 at batch
   128, the teacher from a seeded .pt the port's exporter writes (1.7 GB,
   deleted after), 2 warm-up + 3 timed steps (the student: #1, #2, #3;
   the teacher: #6 and #4 in vision, #1 and #2 in text; #5), distill_loss
   finite, launches per step asserted; one step with the teacher kernels
   on vs off at batch 32, and one ``pure_bf16`` ViT-B-32 step kernels on
   vs off, at phase 6's bars;
22. zoo: the model zoo's towers at full width and depth from a seeded
   init. EVA02-L-14 (EVA-02 L/14: rope, SwiGLU, #6 in its 24 vision
   blocks at L = 257) and ViTamin-L-256 (#6 in its 31 blocks at L = 256)
   through ``cli.main`` on synthetic data, 2 warm-up + 3 timed steps at
   the largest batch <= 128 that fits without checkpointing
   (--zoo-batch-probe): samples/s, p50 step ms, peak memory, launches per
   step asserted (their text towers on #1, #2, #3); one forward of 8 in
   bf16 with the kernels on and off of EVA01-g-14 (#6 at dh 88),
   EVA02-E-14-plus (dh 112), ViTamin-XL-256 (dh 72), convnext_base_w,
   swin_base_patch4_window7_224, MobileCLIP-S2, mt5-base-ViT-B-32 and
   nllb-clip-base (features at per-sample cosine >= 0.99, #6's launches
   asserted); one train step kernels on vs off at batch 16 of EVA02-L-14,
   ViTamin-L-256, convnext_base_w and MobileCLIP-S2 (BatchNorms in train
   mode) at phase 6's bars.

23. pretrained: the paper's recipes as their scripts write them. (a)
   scar_openclip_pretrain.sh's flags through ``main_other.main`` with
   ``--pretrained laion400m_e32`` resolved offline (HF_HUB_OFFLINE=1)
   from a temporary HF_HUB_CACHE whose timm/vit_base_patch32_clip_224
   .laion400m_e32 snapshot holds a seeded full-width ViT-B-32 checkpoint
   as open_clip_model.safetensors (605 MB), one epoch of 64 + 32 seeded
   scar rows at batch 32: every CLIP parameter at the first step equal to
   the file's tensor, the tag head and TQN at their seeded init, #1, #2,
   #3 and #5 launched, the loss finite; the resolve + load seconds and
   the bytes printed; (b) ``create_model("ViT-B-32", pretrained=
   "openai")`` from an fp16 OpenAI-layout archive in the openai repo's
   snapshot, its values loaded exactly, one serve batch of 32 kernels vs
   plain at phase 4's bars; (c) adamw (the default, for its time in the
   same window), adam, sgd, lion and adafactor: 5 steps
   of 32 on the XTag model (samples/s, p50 step ms, launches per step
   asserted), one step kernels on vs off with each parameter's update at
   phase 6's bars, and one update from fixed fp32 gradients on the card
   against the CPU's within 1e-6 by norm; (d) ``save_hf_checkpoint`` of
   the tuned model reloaded through ``pretrained="hf-hub:..."`` bit for
   bit, and ``ops/int8.py`` at [4096, 768] x [768, 3072]: the int32 sums
   equal the CPU's.

24. dist (last): the port's multi-process training on the one card.
   (a) scar_openclip_pretrain.sh's flags (--local-loss, the XTag ViT-B-32
   with tagging and fusion, seeded random init, batch 32, one epoch of
   DIST_ROWS seeded scar PNGs, no --pretrained) through
   ``main_other.main`` twice: launcher-free, and under ``python -m
   torch.distributed.run --standalone --nproc_per_node 1`` (NCCL, DDP at
   world size 1), both with one loader thread and the train transform's
   random.Random seeded (its crops are unseeded otherwise). Every step's
   loss and the final parameters bit for bit equal, the launches of #1,
   #2, #3 and #5 equal and at least the plain step's per step. (b) in
   the launcher's process that ran (a): CLIPA ViT-H/14 stage 2 at 224 px
   with the script's --fsdp --local-loss --gather-with-grad
   --grad-checkpointing at batch 256 on seeded tar shards through
   ``cli.main`` (FSDP2 at world size 1; half depth, CLIPA_DEPTH_CUT, or
   full depth with --dist-only), its launches per step asserted; then
   one step of the same model with and without --fsdp from the same
   weights, batch and dropout seed at phase 6's bars (loss 1e-2,
   gradient norm 2%, gradient cosines 0.99), each timed over
   DIST_TIMED_STEPS steps with its peak memory. (c) two ranks on the one
   card over gloo (NCCL takes one rank per card; gloo moves the CUDA
   tensors of DDP's broadcast and all-reduce and the losses'
   all-gathers, and refuses batch_isend_irecv, which only the SigLIP
   rings use): the XTag ViT-B-32 step with tagging and fusion at 16 a
   rank, deterministic, against the one-process step on the concatenated
   32 at phase 6's bars.

25. tp: tensor parallelism (``--model-parallel``, parallel/sharding.py
   and parallel/tensor_parallel.py). (a) every partial-mode kernel at its
   sharded path shape (N = TP_N = 2: the attention half and its backward
   at the vision stream B 32 x L 50, D 768, 6 of 12 heads and the causal
   text stream B 32 x L 77, D 512, 4 of 8 heads; the MLP half at 1600 x
   768 and 2464 x 512 rows on half the hidden width; the fused MLP at
   ViT-H-14's 8224 x 1280 rows on 2560 of 5120; flash attention on 8 of
   ViT-H-14's 16 heads of 80 at L 257) against its plain version and,
   its N shards' partials summed in fp32 with the bias and residual
   added once, against the whole-width kernel, both within atol =
   max|ref|/128 and rtol 1e-2; the rows join the kernel table with their
   device time, plain time and bound. (b) scar_openclip_pretrain.sh's
   flags (phase 24's) plus --model-parallel 2 through ``main_other.main``
   on two gloo ranks of the one card (seeded crops, one loader thread),
   against the launcher-free run on the same rows: each step's loss
   within 1e-2 relative, both finite, and each rank launching #1, #2, #3
   and #5 as the launcher-free run does. Phase 24 makes it in its (c)'s
   two processes, against its (a)'s launcher-free run (DIST_ROWS rows,
   16 steps of 32), and prints its own ``tp`` line. (c) with
   ``--tp-only``: CLIPA ViT-H-14 stage 2 at full width and
   depth, --grad-checkpointing, batch 32: one step on two gloo ranks at
   --model-parallel 2 against the one-process step at phase 6's bars,
   with each rank's peak memory beside the one-process peak; and
   ViT-B-16-plus-240 at batch 32 on TP_UNEVEN_N = 4 gloo ranks, its heads
   uneven (vision 14: 4, 4, 3, 3 on the non-fused route; text 10: 3, 3,
   2, 2 on the fused halves' partial modes), at the same bars; and
   swin_base_patch4_window7_224, cut to one block a stage, at batch 16 on
   TP_SWIN_N = 8 gloo ranks: its first stage's attention (4 heads, fewer
   than the ranks) replicated whole on every rank, the rest split, at the
   same bars. (d) tp_zoo,
   the towers outside the ResidualAttentionBlocks (parallel/sharding.py's
   plans): in (b)'s two processes, after it, EVA02-L-14 at full width
   (1024, 16 heads of 64, SwiGLU 2730 with its mlp_norm, rope) cut to
   TP_ZOO_LAYERS vision blocks, its ResidualAttentionBlock text tower
   whole: one contrastive step of TP_ZOO_BATCH at --model-parallel 2
   against the one-process step at phase 6's bars, each rank launching
   #6 (on 8 of 16 heads) and the text tower's #1-#3 as the one-process
   run does; with ``--tp-zoo-only``, at full depth, EVA02-L-14 at
   TP_ZOO_BATCH, ViT-SO400M-14-SigLIP at TP_ZOO_BATCH (the timm ViT with
   its map pool, the text tower at hidden width 4304) and mt5-xl-ViT-H-14
   at TP_ZOO_MT5_BATCH (T5 with its token table split by rows, its
   dropout on; in fp32, beside the one-process bf16 step's distance from
   the fp32 one: TP_ZOO_MODELS says why), each rank's peak memory beside
   the one-process peak and the share of the parameters' bytes each rank
   holds. Gloo stages CUDA
   tensors through the host, so no time of (b), (c) or (d) is a speed.
   (a) holds #6 at EVA02-L-14's local shape (TP_ZOO_BATCH, 8 of 16, 257,
   64), forward and backward, to the whole-head kernel too.

After phase 8, fp16: the GAP tower of phase 8 in ``pure_fp16`` (float16
parameters but the LayerNorms'), one serve batch of 32 and one train step
of 32, each against the plain route (use_kernels off, the plain
normalize) at phases 4 and 6's bars (the step's noise floor from images
one float16 step up and down): its vision cores run #6's float16
kernels (12 forwards a batch, 12 forwards and 12 backwards a step), the
normalize #5 (fp32, then one cast), and #1-#4 and #6's bf16 kernels
nothing, the prompt table included. Then intermediates:
``forward_intermediates`` of phase 3's ViT-B-32 and phase 8's GAP tower
in bf16, every block of both towers, with the logits, on 32 images and
32 scar prompts: the final features bit-equal to ``encode_image`` /
``encode_text``, one forward's launches, and every block's output, the
features and the logits against the plain route at the serve bar
(cosine >= 0.999 a sample; logits within 5e-2). The kernel rows hold
#6's float16 instantiations (FLASH_F16_CASES) to their plain versions in
float16 beside SDPA in float16.

After phase 2, flash_poison: flash attention at head dims 80 and 112
(L = 257) and at the 336 px eval's L = 577 (dh 80) on q, k, v, dO whose
columns past dh and rows past L hold NaN (rows of dh + 48 columns,
batches of L + 64 rows): outputs finite and equal bit for bit to those of
the same inputs copied contiguous.

With ``--profile`` it also traces the trainer's second plain epoch, 3
CLIPA stage-2 train steps of 256, the biomedclip_scar epoch, one CoCa
generate call (top-k) and 3 CoCa train steps of 128, and then one
precompute, 20 serve batches and 5 train steps of each model,
with torch.profiler, and prints, for each window, its wall
time, the device's kernel time, the device's busy share (kernel time over
wall time; the kernels run on one stream) and the device time per kernel,
split into the port's hand-written kernels and everything else.

``--coca-only`` runs the build, the kernel rows and phases 19 and 18
alone, then prints the seconds, the kernel table with those phases'
launches and the card; ``--siglip-only`` the same for phases 20 and 21,
``--zoo-only`` for phase 22, ``--pretrained-only`` for phase 23,
``--dist-only`` for phase 24 (with the CLIPA model at full depth) and
phase 25's (b), ``--tp-only`` for phase 25's (c), ``--tp-zoo-only``
for phase 25's (d) at full depth, ``--fp16-only`` for fp16 and
intermediates; ``--tp-nccl`` (four
cards) runs the build and phase_tp_nccl alone.
``--siglip-batch-probe`` runs only the build and phase_siglip_batch_probe
(ViT-SO400M-14-SigLIP through cli.main at growing batches until one runs
out of memory, without and with --grad-checkpointing);
``--zoo-batch-probe`` the build and phase_zoo_batch_probe (the zoo
trainers from batch 128 down until one fits).

Then each phase's seconds, the kernel table (every kernel's launches on
the main paths, its times and its bound), the card's name and power limit
(nvidia-smi) and,
as the last line, {"ok": true, "device": {...}}. Any failure raises: the
exit code is then not 0 and the last line is not printed. Without a CUDA
device it exits 1 before doing anything. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import io
import json
import logging
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the card's published dense bf16 peak (FLOP/s), fp32 peak outside the
# tensor cores (FLOP/s) and memory rate (bytes/s)
_PEAKS = (
    ("H100 PCIe", 756e12, 51e12, 2.0e12),
    ("H100 NVL", 835e12, 60e12, 3.9e12),
    ("H200", 989e12, 67e12, 4.8e12),
    ("H100", 989e12, 67e12, 3.35e12),
)
SERVE_BATCH = 32
N_SERVE_BATCHES = 200  # the timed window
N_WARMUP_BATCHES = 2
N_IMAGE_BATCHES = 8  # distinct seeded batches, cycled; re-run through plain
PRECOMPUTE_BATCH = 512
IMAGE_SIZE = 224
TRAIN_BATCH = SERVE_BATCH  # the kernel rows' batch: they are the step's shapes
N_TRAIN_WARMUP = 3
N_TRAIN_STEPS = 30  # the timed window
N_TRAIN_BATCHES = 4  # distinct seeded batches, cycled
# the paper recipe (scar_openclip_pretrain.sh): AdamW and cosine schedule
TRAIN_LR, TRAIN_WD, TRAIN_WARMUP = 5e-5, 0.1, 50
TRAIN_SCHEDULE_STEPS = 10_000  # nominal length: sets only the cosine decay
# the cls-free GAP tower: ViT-B-16's config with these vision overrides,
# and the name the CLI phase gives its JSON (XTAGCLIP_EXTRA_CONFIGS)
GAP_IMAGE_SIZE = 256
GAP_VISION = {"image_size": GAP_IMAGE_SIZE, "pool_type": "avg",
              "no_class_token": True}
GAP_CONFIG = "ViT-B-16-GAP-256"
GAP_L = (GAP_IMAGE_SIZE // 16) ** 2
# the CLIPA ViT-H/14 recipe (BASELINE config 5; scripts/h14_84_8_pretrain.sh,
# scripts/h14_224_32_finetune.sh) through cli.main: the per-device batch
# (the scripts' 4096 cut to what one card's 80 GB holds), 2 warm-up + 3
# timed stage-2 steps, the eval CSV's rows, and the batch of the clipa_path
# comparisons and of the kernel rows at ViT-H widths
CLIPA_BATCH = 256
CLIPA_WARMUP, CLIPA_STEPS = 2, 3
CLIPA_VAL_ROWS = 128
CLIPA_PATH_BATCH = 32
CLIPA_SHARDS = 8  # the stages' tar shards: 8 x 224 samples, stage 2's 1792
# the 336 px evaluation (scripts/clipav2_vit_h14_i84_224_336_cl32_gap_
# datacomp1b.sh, ViT-H-14-CL32-GAP-BigVision): 24 x 24 patches + the class
# token, at the eval batch
CLIPA_EVAL_BATCH = 64
EVAL_IMAGE_SIZE = 336
# its text tower runs only in the zero-shot classifier, on chunks of 10
# classes x 80 templates (train/zero_shot.py) at the config's 32 tokens
EVAL_CHUNK_PROMPTS = 10 * 80
EVAL_L = (EVAL_IMAGE_SIZE // 14) ** 2 + 1
# coca_ViT-L-14 (open_clip's config behind laion2b_s13b_b90k and the
# mscoco_finetuned checkpoints; 638M parameters): captions at batch 8 and
# seq_len 30 by the three generation methods at JAX's defaults (top-k 1,
# top-p 0.1, 6 beams in 3 groups), and open_clip README's MSCOCO
# fine-tune recipe through cli.main at its batch of 128 (2 warm-up + 3
# timed steps), then evaluate on a val CSV; the kernels-on/off step runs
# at a smaller batch (the plain attention's fp32 scores of 24 ViT-L
# blocks at 128 would not fit beside two models)
COCA_MODEL = "coca_ViT-L-14"
COCA_GEN_BATCH, COCA_SEQ_LEN, COCA_GEN_RUNS = 8, 30, 3
COCA_BEAMS = 6
COCA_METHODS = {"top_k": dict(generation_type="top_k"),
                "top_p": dict(generation_type="top_p"),
                "beam_search": dict(generation_type="beam_search",
                                    num_beams=COCA_BEAMS,
                                    num_beam_groups=3)}
COCA_BATCH = 128
COCA_WARMUP, COCA_STEPS = 2, 3
COCA_VAL_ROWS = 256
COCA_PATH_BATCH = 32
COCA_L = (IMAGE_SIZE // 14) ** 2 + 1  # ViT-L/14's 257 tokens
COCA_TEXT_L = 77  # 76 tokens and the class token
# ViT-B-16-SigLIP (the config behind open_clip's public webli weights):
# timm ViT-B/16 with the MAP pool (plain PyTorch, as JAX runs it through
# XLA), text 12 x 768 at 64 tokens without causal mask (#1, #2, #3), a
# logit bias of -10; its published recipe's batch of 32k spans many cards,
# so one card trains at 256. ViT-SO400M-14-SigLIP: timm SO400M/14 (plain)
# and text 27 x 1152, 16 heads of 72, 16 tokens, MLP 4304 (#6 at dh 72, #4
# at 1152 -> 4304), at the largest batch the card holds
# (--siglip-batch-probe). Distillation as open_clip's README documents it
# (--distill-model ViT-L-14 --distill-pretrained openai), the teacher a
# seeded .pt written by the port's exporter, student ViT-B-32 at 128.
SIGLIP_MODEL = "ViT-B-16-SigLIP"
SIGLIP_TOKENIZER = "timm/ViT-B-16-SigLIP"  # both configs' hf_tokenizer_name
SIGLIP_BATCH = 256
SIGLIP_WARMUP, SIGLIP_STEPS = 2, 3
SIGLIP_L = 64
SIGLIP_PATH_BATCH = 64
SO400M_MODEL = "ViT-SO400M-14-SigLIP"
SO400M_BATCH = 64
SO400M_WARMUP, SO400M_STEPS = 1, 3
SO400M_L = 16
SO400M_HIDDEN = 4304
SO400M_PROBE = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)
DISTILL_STUDENT, DISTILL_TEACHER = "ViT-B-32", "ViT-L-14"
DISTILL_BATCH = 128
DISTILL_WARMUP, DISTILL_STEPS = 2, 3
DISTILL_PATH_BATCH = 32
DISTILL_L = (IMAGE_SIZE // 14) ** 2 + 1  # the teacher's ViT-L/14 tokens
SIGLIP_PER_STEP = dict(fused_attn_half=12, fused_mlp_half=12,
                       fused_attn_half_bwd=12, normalize_images=1)
SO400M_PER_STEP = dict(flash_mha=27, flash_mha_bwd=27, fused_mlp=27,
                       normalize_images=1)
# the student's 12 + 12 blocks forward and backward, the teacher's 24
# vision blocks (#6, #4) and 12 text blocks (#1, #2) forward only
DISTILL_PER_STEP = dict(fused_attn_half=36, fused_mlp_half=36,
                        fused_attn_half_bwd=24, flash_mha=24, fused_mlp=24,
                        normalize_images=1)
# the model zoo's towers (EVA-01/02, ViTamin, ConvNeXt, Swin, FastViT, mT5,
# NLLB; open_clip's configs of those names): EVA02-L-14 and ViTamin-L-256
# train through cli.main at the largest batch <= 128 that fits without
# checkpointing (--zoo-batch-probe: 112 for both, EVA02-L at 71.2 GB over
# resident; ViTamin-L at 83.1 GB, 98% of the card, so it trains at 96),
# 2 warm-up + 3 timed steps; eight
# configs run one forward of ZOO_FWD_BATCH with the kernels on and off;
# four run one train step kernels on vs off at ZOO_PATH_BATCH. #6 runs in
# the EVA and ViTamin vision blocks (EVA02-L: 24 x L 257 at dh 64;
# ViTamin-L: 31 x L 256 at dh 64), the text towers on #1-#3
ZOO_TRAINERS = (("eva02_l", "EVA02-L-14", 112),
                ("vitamin_l", "ViTamin-L-256", 96))
ZOO_WARMUP, ZOO_STEPS = 2, 3
ZOO_FWD_BATCH = 8
ZOO_FORWARD = ("EVA01-g-14", "EVA02-E-14-plus", "ViTamin-XL-256",
               "convnext_base_w", "swin_base_patch4_window7_224",
               "MobileCLIP-S2", "mt5-base-ViT-B-32", "nllb-clip-base")
ZOO_PATH = ("EVA02-L-14", "ViTamin-L-256", "convnext_base_w",
            "MobileCLIP-S2")
ZOO_PATH_BATCH = 16
ZOO_PROBE = (128, 112, 96, 80, 64)
_TEXT_HALVES = dict(fused_attn_half=12, fused_mlp_half=12,
                    fused_attn_half_bwd=12, normalize_images=1)
ZOO_PER_STEP = {"EVA02-L-14": dict(_TEXT_HALVES, flash_mha=24,
                                   flash_mha_bwd=24),
                "ViTamin-L-256": dict(_TEXT_HALVES, flash_mha=31,
                                      flash_mha_bwd=31)}
# #6's launches in one kernels-on forward of each ZOO_FORWARD config (its
# vision blocks; every other wrapper counted is in the printed line)
ZOO_FWD_FLASH = {"EVA01-g-14": 40, "EVA02-E-14-plus": 64,
                 "ViTamin-XL-256": 32}
ZOO_FWD_COS = 0.99  # per-sample cosine of kernels-on vs -off features
# the paper's recipes as their scripts write them (scar_openclip_pretrain.sh
# and the others pass --pretrained laion400m_e32): a seeded ViT-B-32
# open_clip checkpoint as open_clip_model.safetensors in a hub cache for the
# registry's repo, main_other.main with the script's flags at batch 32
# for one short epoch; ViT-B-32 from an fp16 OpenAI-layout archive in the
# openai repo's snapshot, served; each optimizer JAX's make_optimizer takes
# for 5 steps of 32 on the XTag model, kernels on vs off and
# one update card vs CPU; the HF export's round trip; int8 at a ViT-B MLP's
# shape
PRETRAINED_MODEL = "ViT-B-32"
PRETRAINED_TAG = "laion400m_e32"
PRETRAINED_HUB = "timm/vit_base_patch32_clip_224.laion400m_e32"
OPENAI_HUB = "timm/vit_base_patch32_clip_224.openai"
EXPORT_HUB = "xtag/vit-b-32-scar"
PRETRAINED_ROWS = {"scar_train": 64, "scar_val": 32}
PRETRAINED_PER_STEP = dict(fused_attn_half=24, fused_mlp_half=24,
                           fused_attn_half_bwd=24, normalize_images=1)
# AdamW first: the default's time in the same window as the others'
OPTIMIZERS = ("adamw", "adam", "sgd", "lion", "adafactor")
OPT_STEPS = 5  # the first is the warm-up of the timed window
OPT_UPDATE_REL = 1e-6  # one update from fixed gradients, card vs CPU
# the parameters of that update: the patch conv, a vision and a text block
# and the token embedding (adafactor's factored and unfactored leaves), the
# tag head, TQN and the logit scale (60.9M of the 174.3M, to keep the CPU's
# side short)
OPT_CPU_PARAMS = ("visual.conv1", "visual.transformer.resblocks.0.",
                  "text.transformer.resblocks.0.", "text.token_embedding",
                  "tag_", "fusion_model.", "logit_scale")
INT8_SHAPE = (4096, 768, 3072)  # [M, K] x [K, N]: ViT-B-32 c_fc at 128 x 32
DIST_ROWS = 512  # (a): 16 steps of TRAIN_BATCH
DIST_CLIPA_STEPS = 3  # (b): cli.main --fsdp steps of CLIPA_BATCH
DIST_TIMED_STEPS = 3  # (b): the FSDP and no-FSDP steps timed after the first
DIST_GLOO_BATCH = 16  # (c): a rank's batch; the one-process step takes 32
DIST_TIMEOUT = 900  # seconds a worker command may take
# flash_block: a causal text block no fused half takes (8 heads of 128)
FLASH_BLOCK = dict(width=1024, heads=8, length=77, batch=TRAIN_BATCH)
# decode_serve: one serve batch as JPEGs of a phone photo's 480 x 640
DECODE_SIDE_HW = (480, 640)
DECODE_REPS = 10  # timed decode + serve batches after one warm-up
MULTI_STEPS = 3  # multi_step: optimizer steps in one make_multi_step call
# the device code of csrc/ (fused_attn_half.cu, fused_mlp_half.cu,
# fused_attn_half_bwd.cu, normalize_images.cu, flash_attn_{fwd,bwd}.cuh
# in four libraries, fused_mlp.cu), and gemm_bf16_kernel, the WMMA GEMM of
# earlier commits' fused halves, for their packages run under this script
PORT_KERNELS = ("gemm_bf16_kernel", "gemm_sm90_kernel", "attn_core_kernel",
                "ln_rows_kernel", "mask_by_thread_kernel",
                "attn_bwd_core_kernel", "ln_bwd_rows_kernel",
                "ln_bwd_cols_kernel", "col_sum_kernel", "normalize_u8_kernel",
                "flash_fwd_kernel", "flash_delta_kernel", "flash_dkv_kernel",
                "flash_dq_kernel")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]


def _peaks(name: str):
    """{"bf16": FLOP/s, "fp16": FLOP/s (the same dense tensor-core rate),
    "fp32": FLOP/s}, bytes/s of the card ``name``."""
    for key, bf16, fp32, rate in _PEAKS:
        if key in name:
            return {"bf16": bf16, "fp16": bf16, "fp32": fp32}, rate
    raise RuntimeError(f"no published peak rates for {name!r}")


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _median_ms(fn, reps: int = 7, per_rep: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` of (CUDA-event time of ``per_rep`` back-to-back
    calls) / ``per_rep``: the host enqueues ahead, so this is device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def _profiled_split(fn, calls: int = 20, warmup: int = 3) -> dict:
    """{kernel: device ms} of one call of ``fn``: the durations of the
    kernels and copies it runs on the card (torch.profiler, tracing the
    card's activity alone: tracing the host's ops as well gives the same
    device times, slower), per call. For
    a call whose host side takes longer than its device side, where CUDA
    events would time the host's launch gaps. The profiler can drop events:
    each kind counts as its mean duration times its launches per call (its
    count over ``calls``, rounded, at least one), and a window that recorded
    no device event is traced again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kinds = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.count > 0]
        if kinds:
            return {e.key: _device_time_us(e) / e.count
                    * max(1, round(e.count / calls)) / 1e3 for e in kinds}
    raise RuntimeError("torch.profiler recorded no device event in 3 windows")


def _profiled_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` (see _profiled_split)."""
    return sum(_profiled_split(fn, calls, warmup).values())


def _close(out, ref):
    """(ok, max_abs_err, atol) under atol = max|ref|/128, rtol = 1e-2."""
    out, ref = out.float(), ref.float()
    atol = ref.abs().max().item() / 128
    err = (out - ref).abs()
    ok = bool((err <= atol + 1e-2 * ref.abs()).all().item()
              and torch.isfinite(out).all().item())
    return ok, err.max().item(), atol


def _kernel_cases(gen):
    """The kernels' arguments at the serving path's shapes."""
    from xtagclip_tpu_torch.models.text import build_causal_mask

    dev = "cuda"

    def rnd(shape, std=1.0, dtype=torch.float32):
        t = torch.randn(shape, generator=gen, device=dev) * std
        return t.to(dtype)

    bf = torch.bfloat16
    cases = []
    # the attention half at a serve batch's vision and text blocks, at a
    # precompute chunk's text blocks (512 prompts of 77 tokens), and at
    # ViT-H-14's text blocks: the kernels-on/off step's batch, and the
    # recipe's batch at stage 2's 32 tokens and stage 1's 8
    for tower, batch, l, d, h, causal in (
            ("vision", SERVE_BATCH, 50, 768, 12, False),
            ("text", SERVE_BATCH, 77, 512, 8, True),
            ("text", PRECOMPUTE_BATCH, 77, 512, 8, True),
            ("ViT-H-14 text", CLIPA_PATH_BATCH, 32, 1024, 16, True),
            ("ViT-H-14 text", CLIPA_BATCH, 32, 1024, 16, True),
            ("ViT-H-14 text", CLIPA_BATCH, 8, 1024, 16, True),
            ("ViT-H-14 BigVision text", EVAL_CHUNK_PROMPTS, 32, 1024, 16,
             False),
            # CoCa's decoder self-attention: training (75 positions), and
            # a generation step's [B, 30] buffer (top-k/top-p, beams)
            ("CoCa decoder", COCA_BATCH, COCA_TEXT_L - 2, 768, 12, True),
            ("CoCa decoder generation", COCA_GEN_BATCH, COCA_SEQ_LEN, 768,
             12, True),
            ("CoCa decoder generation", COCA_GEN_BATCH * COCA_BEAMS,
             COCA_SEQ_LEN, 768, 12, True),
            # ViT-B-16-SigLIP's text blocks (64 tokens, no mask) at its
            # batch; distillation's student ViT-B-32 at 128 (vision, text)
            # and its ViT-L-14 teacher's text blocks
            ("SigLIP text", SIGLIP_BATCH, SIGLIP_L, 768, 12, False),
            ("distill student vision", DISTILL_BATCH, 50, 768, 12, False),
            ("distill student text", DISTILL_BATCH, 77, 512, 8, True),
            ("distill teacher text", DISTILL_BATCH, 77, 768, 12, True)):
        x = rnd((batch, l, d), dtype=bf)
        args = (x, 1 + rnd(d, 0.1), rnd(d, 0.1),
                rnd((d, 3 * d), d**-0.5, bf), rnd(3 * d, 0.1),
                rnd((d, d), d**-0.5, bf), rnd(d, 0.1),
                build_causal_mask(l, dev) if causal else None, h, 1e-5)
        flops = 2 * batch * l * d * (4 * d + 2 * l)
        nbytes = (2 * 2 * batch * l * d + 2 * 4 * d * d
                  + 4 * (4 * d + 2 * d) + (4 * l * l if causal else 0))
        cases.append(("fused_attn_half", f"{tower} B={batch} L={l} "
                      f"D={d} H={h}{' causal' if causal else ''}",
                      args, flops, nbytes, "bf16", None))
    # the MLP half at a serve batch's vision and text rows, at a
    # precompute chunk's text rows (512 prompts of 77 tokens), and at
    # ViT-H-14's text rows (as the attention half's; its act is gelu)
    both = ("gelu", "quick_gelu")
    for tower, batch, l, d, acts in (
            ("vision", SERVE_BATCH, 50, 768, both),
            ("text", SERVE_BATCH, 77, 512, both),
            ("text", PRECOMPUTE_BATCH, 77, 512, both),
            ("ViT-H-14 text", CLIPA_PATH_BATCH, 32, 1024, both),
            ("ViT-H-14 text", CLIPA_BATCH, 32, 1024, ("gelu",)),
            ("ViT-H-14 text", CLIPA_BATCH, 8, 1024, ("gelu",)),
            ("ViT-H-14 BigVision text", EVAL_CHUNK_PROMPTS, 32, 1024,
             ("gelu",)),
            # CoCa: the decoder's self- and cross-attention blocks and the
            # masked text tower in training; a generation step's decoder
            # (30) and text (31) rows, top-k/top-p and beams
            ("CoCa decoder", COCA_BATCH, COCA_TEXT_L - 2, 768, ("gelu",)),
            ("CoCa text", COCA_BATCH, COCA_TEXT_L, 768, ("gelu",)),
            ("CoCa decoder generation", COCA_GEN_BATCH, COCA_SEQ_LEN, 768,
             ("gelu",)),
            ("CoCa text generation", COCA_GEN_BATCH, COCA_SEQ_LEN + 1, 768,
             ("gelu",)),
            ("CoCa decoder generation", COCA_GEN_BATCH * COCA_BEAMS,
             COCA_SEQ_LEN, 768, ("gelu",)),
            ("CoCa text generation", COCA_GEN_BATCH * COCA_BEAMS,
             COCA_SEQ_LEN + 1, 768, ("gelu",)),
            # SigLIP's text rows; the distillation student's (its
            # teacher's text rows are CoCa text's: 128 x 77 at D 768)
            ("SigLIP text", SIGLIP_BATCH, SIGLIP_L, 768, ("gelu",)),
            ("distill student vision", DISTILL_BATCH, 50, 768, ("gelu",)),
            ("distill student text", DISTILL_BATCH, 77, 512, ("gelu",))):
        hd = 4 * d
        n = batch * l
        for act in acts:
            x = rnd((batch, l, d), dtype=bf)
            args = (x, 1 + rnd(d, 0.1), rnd(d, 0.1), rnd((d, hd), d**-0.5, bf),
                    rnd(hd, 0.1), rnd((hd, d), hd**-0.5, bf), rnd(d, 0.1),
                    act, 1e-5)
            flops = 4 * n * d * hd
            nbytes = 2 * 2 * n * d + 2 * 2 * d * hd + 4 * (3 * d + hd)
            cases.append(("fused_mlp_half", f"{tower} N={n} D={d} "
                          f"H={hd} {act}", args, flops, nbytes, "bf16", None))
    for tower, b, l, d, h, causal in (
            ("vision", TRAIN_BATCH, 50, 768, 12, False),
            ("text", TRAIN_BATCH, 77, 512, 8, True),
            ("ViT-H-14 text", CLIPA_PATH_BATCH, 32, 1024, 16, True),
            ("ViT-H-14 text", CLIPA_BATCH, 32, 1024, 16, True),
            ("ViT-H-14 text", CLIPA_BATCH, 8, 1024, 16, True),
            ("CoCa decoder", COCA_BATCH, COCA_TEXT_L - 2, 768, 12, True),
            ("SigLIP text", SIGLIP_BATCH, SIGLIP_L, 768, 12, False),
            ("distill student vision", DISTILL_BATCH, 50, 768, 12, False),
            ("distill student text", DISTILL_BATCH, 77, 512, 8, True)):
        args = (rnd((b, l, d), dtype=bf), rnd((b, l, d), dtype=bf),
                1 + rnd(d, 0.1), rnd(d, 0.1), rnd((d, 3 * d), d**-0.5, bf),
                rnd(3 * d, 0.1), rnd((d, d), d**-0.5, bf),
                build_causal_mask(l, dev) if causal else None, h, 1e-5)
        # the Pallas CostEstimate (fused_attn_block.py:728-733), plus the
        # fp32 LN/bias/mask reads and [D] sums
        flops = 2 * b * l * d * (8 * d + 6 * l)
        nbytes = (2 * (2 * b * l * d + 4 * d * d)
                  + 2 * (b * l * d + 3 * b * l * d) + 4 * d * d
                  + 4 * (5 * d + 3 * d) + (4 * l * l if causal else 0))
        cases.append(("fused_attn_half_bwd", f"{tower} B={b} L={l} D={d} "
                      f"H={h}{' causal' if causal else ''}", args, flops,
                      nbytes, "bf16", None))
    # the image normalize: the main path's batch, a ragged batch whose
    # element count is odd (the kernel's scalar tail), the 336 px eval's
    # and the baselines' batch (to fp32 there); one FMA an element
    from xtagclip_tpu_torch.utils.constants import (
        OPENAI_DATASET_MEAN,
        OPENAI_DATASET_STD,
    )

    for shape in ((SERVE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), (5, 33, 47, 3),
                  (CLIPA_EVAL_BATCH, EVAL_IMAGE_SIZE, EVAL_IMAGE_SIZE, 3),
                  (BASELINE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3),
                  (COCA_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3),
                  (SIGLIP_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3),
                  (SO400M_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)):
        images = torch.randint(0, 256, shape, generator=gen, device=dev,
                               dtype=torch.uint8)
        n = images.numel()
        for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
            cases.append(("normalize_images", f"{'x'.join(map(str, shape))} "
                          f"uint8 -> {str(dtype)[6:]}",
                          (images, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD,
                           dtype), 2 * n, n * (1 + size), "fp32", None))
    cases += _gap_kernel_cases(gen)
    return cases


# flash attention's shapes: the GAP tower's (32, 12, 256, 64), then edge
# shapes (B, H, L, dh): L at one tile, ragged L (ViT-B-16's 197 with its
# class token, ViT-L-14's 257), several tiles, head dim 128; then
# ViT-H-14's dh 80 at the CLIPA paths' shapes (stage 2 at 224 px, L = 257,
# at the kernels-on/off step's batch and the recipe's; stage 1 at 84 px,
# L = 37, at the recipe's batch; the 336 px BigVision eval, L = 577, at its
# batch of 64) and the other head dims the 128-wide instantiation takes
FLASH_CASES = ((TRAIN_BATCH, 12, GAP_L, 64), (1, 12, 128, 64),
               (1, 12, 197, 64), (1, 12, 257, 64), (1, 12, 384, 64),
               (2, 4, 256, 128), (CLIPA_PATH_BATCH, 16, 257, 80),
               (CLIPA_BATCH, 16, 257, 80), (CLIPA_BATCH, 16, 37, 80),
               (CLIPA_EVAL_BATCH, 16, EVAL_L, 80),
               (2, 4, 257, 72), (2, 4, 257, 88), (2, 4, 257, 104),
               (2, 4, 257, 112),
               # coca_ViT-L-14's vision tower: the recipe's batch, and a
               # generation batch's encode
               (COCA_BATCH, 16, COCA_L, 64), (COCA_GEN_BATCH, 16, COCA_L, 64),
               # ViT-SO400M-14-SigLIP's text tower: 16 tokens, 16 heads of
               # 72 (the distillation teacher's vision is CoCa's shape)
               (SO400M_BATCH, 16, SO400M_L, 72),
               # the zoo: EVA02-L-14 and ViTamin-L-256 at their trainers'
               # batch, EVA02-B-16 at 197, the forwards' EVA01-g (dh 88),
               # EVA02-E (dh 112) and ViTamin-XL (dh 72, at 256 and 224 px)
               (ZOO_TRAINERS[0][2], 16, 257, 64),
               (ZOO_TRAINERS[1][2], 16, 256, 64),
               (ZOO_FWD_BATCH, 12, 197, 64), (ZOO_FWD_BATCH, 16, 257, 88),
               (ZOO_FWD_BATCH, 16, 257, 112), (ZOO_FWD_BATCH, 16, 256, 72),
               (ZOO_FWD_BATCH, 16, 196, 72))
# flash attention under an additive [L, L] mask (the causal mask, fp32 as
# the text towers build it) and at head dim 256 (B, H, L, dh, causal): a
# causal text tower of 8 heads of 128 at 77 tokens, a causal stream at dh
# 64 past the fused half's 128 keys, dh 80 at 77 tokens, and dh 256
# without and with the mask
FLASH_MASK_CASES = ((32, 8, 77, 128, True), (16, 16, 256, 64, True),
                    (32, 16, 77, 80, True), (8, 4, 256, 256, False),
                    (8, 4, 256, 256, True))
# flash attention's float16 instantiations (pure_fp16; no mask): the GAP
# ViT-B-16's shape, which the fp16 phase runs, and ViT-H-14's dh 80 at
# L = 257 (B, H, L, dh)
FLASH_F16_CASES = ((TRAIN_BATCH, 12, GAP_L, 64),
                   (CLIPA_PATH_BATCH, 16, 257, 80))


def _gap_kernel_cases(gen):
    """Kernels #4 and #6 at the GAP path's shapes (and #6 at edge shapes,
    and under the causal mask and at head dim 256, FLASH_MASK_CASES): q,
    k, v are column slices of one [B, L, 3 H dh] projection, as the model
    makes them. Library yardsticks (timed, never called by the port):
    scaled_dot_product_attention forward (with the same mask, in bf16 as
    SDPA takes it), and its forward and backward through autograd. A
    masked row counts the operations of the score pairs the mask leaves
    (its bound: the causal half of the work, what a kernel that skipped
    the masked pairs would do) and the mask's bytes. The float16 rows
    (FLASH_F16_CASES: the ``_f16`` kernels, SDPA in float16) follow the
    bf16 ones."""
    import torch.nn.functional as F

    from xtagclip_tpu_torch.models.text import build_causal_mask
    from xtagclip_tpu_torch.ops import flash_attn

    dev, bf, f16 = "cuda", torch.bfloat16, torch.float16
    cases = []
    for b, h, l, dh, causal, dt in (
            [c + (False, bf) for c in FLASH_CASES]
            + [c + (bf,) for c in FLASH_MASK_CASES]
            + [c + (False, f16) for c in FLASH_F16_CASES]):
        sfx, kind = ("_f16", "fp16") if dt == f16 else ("", "bf16")
        d = h * dh
        qkv = torch.randn((b, l, 3 * d), generator=gen, device=dev).to(dt)
        q, k, v = (t.reshape(b, l, h, dh) for t in qkv.split(d, dim=-1))
        shape = f"B={b} H={h} L={l} dh={dh}" + (" causal" if causal else "")
        elems = b * h * l * dh
        # the score pairs this mask leaves (every one without it), and the
        # mask's bytes, read once
        mask = build_causal_mask(l, device=dev) if causal else None
        pairs = l * (l + 1) // 2 if causal else l * l
        mask_bytes = 4 * l * l if causal else 0
        mask_args = (mask,) if causal else ()
        sdpa_in = [t.transpose(1, 2) for t in (q, k, v)]
        sdpa_kw = {"attn_mask": mask.to(bf)} if causal else {}
        cases.append(("flash_mha" + sfx, shape,
                      (q, k, v, "blhd", *mask_args),
                      4 * b * h * pairs * dh, 4 * 2 * elems + mask_bytes,
                      kind, lambda a=sdpa_in, kw=sdpa_kw:
                      F.scaled_dot_product_attention(*a, **kw)))
        o, lse = flash_attn._flash_fwd(q, k, v, "blhd", with_lse=True,
                                       mask=mask)
        do = torch.randn(o.shape, generator=gen, device=dev).to(dt)
        leaves = [t.detach().clone().requires_grad_(True) for t in sdpa_in]
        do_t = do.transpose(1, 2)
        with torch.inference_mode(False), torch.enable_grad():
            sdpa_out = F.scaled_dot_product_attention(*leaves, **sdpa_kw)

        def sdpa_bwd(out=sdpa_out, leaves=leaves, do_t=do_t):
            with torch.inference_mode(False), torch.enable_grad():
                return torch.autograd.grad(out, leaves, do_t,
                                           retain_graph=True)

        def sdpa_fwd_bwd(leaves=leaves, do_t=do_t, kw=sdpa_kw):
            with torch.inference_mode(False), torch.enable_grad():
                out = F.scaled_dot_product_attention(*leaves, **kw)
                return torch.autograd.grad(out, leaves, do_t)

        cases.append(("flash_mha_bwd" + sfx, shape,
                      (q, k, v, o, lse, do, "blhd", *mask_args),
                      10 * b * h * pairs * dh,
                      8 * 2 * elems + 4 * b * h * l + mask_bytes, kind,
                      {"library": sdpa_bwd, "library_fwd_bwd": sdpa_fwd_bwd}))
    n, d, hd = TRAIN_BATCH * GAP_L, 768, 3072
    for rows, d, hd, acts in ((n, d, hd, ("gelu", "quick_gelu")),
                              (37, d, hd, ("gelu", "quick_gelu")),
                              # ViT-H-14's vision MLP at the kernels-on/off
                              # step's batch, and at the recipe's batch in
                              # stage 2 (257 tokens) and stage 1 (37)
                              (CLIPA_PATH_BATCH * 257, 1280, 5120,
                               ("gelu",)),
                              (CLIPA_BATCH * 257, 1280, 5120, ("gelu",)),
                              (CLIPA_BATCH * 37, 1280, 5120, ("gelu",)),
                              # the 336 px eval's batch of 64 (577 tokens:
                              # 36928 rows, no multiple of 128)
                              (CLIPA_EVAL_BATCH * EVAL_L, 1280, 5120,
                               ("gelu",)),
                              # coca_ViT-L-14's vision MLP at the recipe's
                              # batch and a generation batch
                              (COCA_BATCH * COCA_L, 1024, 4096, ("gelu",)),
                              (COCA_GEN_BATCH * COCA_L, 1024, 4096,
                               ("gelu",)),
                              # ViT-SO400M-14-SigLIP's text MLP: a hidden
                              # width of 4304 = 67 x 64 + 16 (ragged tiles)
                              (SO400M_BATCH * SO400M_L, 1152, SO400M_HIDDEN,
                               ("gelu",))):
        for act in acts:
            x = torch.randn((rows, d), generator=gen, device=dev).to(bf)
            w1 = (torch.randn((d, hd), generator=gen, device=dev)
                  * d**-0.5).to(bf)
            w2 = (torch.randn((hd, d), generator=gen, device=dev)
                  * hd**-0.5).to(bf)
            b1 = torch.randn(hd, generator=gen, device=dev) * 0.1
            b2 = torch.randn(d, generator=gen, device=dev) * 0.1
            tower = "text" if hd == SO400M_HIDDEN else "vision"
            cases.append(("fused_mlp", f"{tower} N={rows} D={d} H={hd} {act}",
                          (x, w1, b1, w2, b2, act), 4 * rows * d * hd,
                          2 * 2 * rows * d + 2 * 2 * d * hd + 4 * (d + hd),
                          "bf16", None))
    return cases


_KERNEL_META = {
    "fused_attn_half": ("xtagclip_tpu_torch/csrc/fused_attn_half.cu",
                        "xtagclip_tpu/ops/fused_attn_block.py:434"),
    "fused_mlp_half": ("xtagclip_tpu_torch/csrc/fused_mlp_half.cu",
                       "xtagclip_tpu/ops/fused_attn_block.py:796"),
    "fused_attn_half_bwd": ("xtagclip_tpu_torch/csrc/fused_attn_half_bwd.cu",
                            "xtagclip_tpu/ops/fused_attn_block.py:543"),
    "normalize_images": ("xtagclip_tpu_torch/csrc/normalize_images.cu",
                         "xtagclip_tpu/ops/preprocess.py:47"),
    "fused_mlp": ("xtagclip_tpu_torch/csrc/fused_mlp.cu",
                  "xtagclip_tpu/ops/fused_mlp.py:62"),
    "flash_mha": ("xtagclip_tpu_torch/csrc/flash_attn_fwd.cuh",
                  "xtagclip_tpu/ops/flash_attn.py:93"),
    "flash_mha_bwd": ("xtagclip_tpu_torch/csrc/flash_attn_bwd.cuh",
                      "xtagclip_tpu/ops/flash_attn.py:93"),
}
# the float16 instantiations: the same kernels (flash_attn_{fwd,bwd}_f16.cu
# instantiate them), the same Pallas kernel replaced
_KERNEL_META["flash_mha_f16"] = _KERNEL_META["flash_mha"]
_KERNEL_META["flash_mha_bwd_f16"] = _KERNEL_META["flash_mha_bwd"]


def _ordered(t):
    """Monotonic integer keys of fp32 values (bf16 widened exactly)."""
    bits = t.float().contiguous().view(torch.int32).long()
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def _close_normalize(out, ref):
    """(ok, max_abs_err, bar): bf16 within one bf16 ULP of the plain
    version on every element; fp32 within one fp32 ulp at the operands'
    scale, 2^-22 (the kernel's one FMA against a multiply and an add)."""
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype == torch.bfloat16:
        ulps = ((_ordered(out) - _ordered(ref)).abs() >> 16).max().item()
        ok, bar = ulps <= 1, "1 bf16 ULP"
    else:
        ok, bar = err <= 2.0**-22, 2.0**-22
    return ok and bool(torch.isfinite(out).all().item()), err, bar
# kernels whose outputs a run checks for bit-for-bit repeats
_REPEATS = ("fused_attn_half", "fused_mlp_half", "fused_attn_half_bwd",
            "flash_mha_bwd", "flash_mha_bwd_f16")
_OUTPUTS = {"fused_attn_half_bwd": ("dx", "dqkv", "dwout", "dbout", "dls",
                                     "dlb"),
            "flash_mha_bwd": ("dq", "dk", "dv"),
            "flash_mha_bwd_f16": ("dq", "dk", "dv")}


def _times(kernel_fn, plain_fn, library) -> dict:
    """ms, plain_ms, library_ms: torch.profiler's device time per call (the
    kernels' summed durations), so a wrapper whose host side outlasts its
    kernel (flash attention's, the normalize's) is timed by its kernel;
    ms_by_kernel: ms split by the kernels the wrapper launches; the
    CUDA-event times of back-to-back calls beside them. ``library`` is None,
    one PyTorch call, or {key: call} timed as ``<key>_ms`` (``library`` is
    the yardstick; flash attention's backward also times SDPA's forward and
    backward together as ``library_fwd_bwd``)."""
    libs = library if isinstance(library, dict) else {"library": library}
    split = _profiled_split(kernel_fn)
    out = {"ms": sum(split.values()),
           "ms_by_kernel": {k[:90]: v for k, v in split.items()},
           "plain_ms": _profiled_ms(plain_fn),
           "event_ms": _median_ms(kernel_fn),
           "plain_event_ms": _median_ms(plain_fn)}
    for key, fn in libs.items():
        out[f"{key}_ms"] = None if fn is None else _profiled_ms(fn)
        if fn is not None:
            out[f"{key}_event_ms"] = _median_ms(fn)
    return out


def _kernel_fns():
    """{name: (kernel wrapper, plain version)}, both taking a case's args."""
    from xtagclip_tpu_torch.ops import flash_attn, fused_mlp, preprocess
    from xtagclip_tpu_torch.ops import fused_attn_block as fab

    def plain_flash_bwd(q, k, v, o, lse, do, layout, mask=None):
        return flash_attn.reference_flash_mha_bwd(q, k, v, o, do, layout,
                                                  mask)

    return {
        "fused_attn_half": (fab.fused_attn_half, fab.reference_attn_half),
        "fused_mlp_half": (fab.fused_mlp_half, fab.reference_mlp_half),
        "fused_attn_half_bwd": (fab.fused_attn_half_bwd,
                                fab.reference_attn_half_bwd),
        "normalize_images": (preprocess.normalize_images,
                             preprocess.normalize_images_reference),
        "fused_mlp": (fused_mlp.fused_mlp, fused_mlp.reference_fused_mlp),
        "flash_mha": (flash_attn.flash_mha, flash_attn.reference_flash_mha),
        "flash_mha_bwd": (flash_attn.flash_mha_bwd, plain_flash_bwd),
        "flash_mha_f16": (flash_attn.flash_mha,
                          flash_attn.reference_flash_mha),
        "flash_mha_bwd_f16": (flash_attn.flash_mha_bwd, plain_flash_bwd),
    }


def phase_kernels(card: str):
    peak_flops, peak_rate = _peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns = _kernel_fns()
    entries = []
    cases = _kernel_cases(gen)  # outside inference mode: the library rows
    # of flash attention's backward run autograd on their own leaves
    with torch.inference_mode():
        for name, shape, args, flops, nbytes, kind, library in cases:
            kernel, plain = fns[name]
            out = kernel(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            outs, refs = ((out, ref) if isinstance(out, tuple)
                          else ((out,), (ref,)))
            close = _close_normalize if name == "normalize_images" else _close
            checks = [close(o, r) for o, r in zip(outs, refs)]
            bad = [i for i, (ok, _, _) in enumerate(checks) if not ok]
            if bad or len(outs) != len(refs):
                raise AssertionError(
                    f"{name} [{shape}]: kernel disagrees with its plain "
                    f"version in outputs {bad}: (ok, max abs err, atol) "
                    f"{checks} (rtol 1e-2)")
            if name in _REPEATS:  # no atomics: a second launch, same bits
                again = kernel(*args)
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(a, o) for a, o in zip(again, outs)):
                    raise AssertionError(f"{name} [{shape}]: two launches "
                                         "on the same inputs differ")
            err = max(c[1] for c in checks)
            names = _OUTPUTS.get(name)
            atol = (checks[0][2] if names is None else
                    {k: c[2] for k, c in zip(names, checks)})
            t_flops, t_bytes = flops / peak_flops[kind], nbytes / peak_rate
            source, replaces = _KERNEL_META[name]
            entries.append({
                "name": name, "shape": shape, "card": card, "route": "cuda",
                "peak_type": kind,
                "source": source, "replaces": replaces, "launches": None,
                "max_abs_err": err, "atol": atol,
                **({"repeats_bit_for_bit": True} if name in _REPEATS else {}),
                **({"max_abs_err_by_output": {
                    k: c[1] for k, c in zip(names, checks)}}
                   if names is not None else {}),
                **_times(lambda: kernel(*args), lambda: plain(*args), library),
                "bound_ms": 1e3 * max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            })
    return entries


def phase_flash_block(card: str) -> dict:
    """Phase 2's block check: one ResidualAttentionBlock of width 1024
    with 8 heads of 128 under the causal mask at L = 77 (FLASH_BLOCK; the
    non-fused route: #6 with the mask, #4), bf16 over fp32 masters, one
    forward and backward with the kernels on and off from the same
    weights, input and output cotangent: the output within atol =
    max|ref|/128 and rtol 1e-2, then phase 6's bars (loss 1e-2, gradient
    norm 2%, each gradient, the input's too, at cosine >= 0.99). Returns
    the kernels-on run's launches (a path of the kernel table)."""
    from xtagclip_tpu_torch.factory import init_params
    from xtagclip_tpu_torch.models.layers import (
        ResidualAttentionBlock,
        set_use_kernels,
    )
    from xtagclip_tpu_torch.models.text import build_causal_mask

    fb = FLASH_BLOCK
    gen = torch.Generator().manual_seed(0)
    blk = ResidualAttentionBlock(fb["width"], fb["heads"])
    init_params(blk, gen)
    blk = blk.cuda()
    mask = build_causal_mask(fb["length"], device="cuda")
    shape = (fb["batch"], fb["length"], fb["width"])
    x = torch.randn(shape, generator=gen).cuda().bfloat16()
    cot = torch.randn(shape, generator=gen).cuda()
    route = blk.route(shape, mask)

    def run(kernels):
        set_use_kernels(blk, kernels)
        blk.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        y = blk(xi, attn_mask=mask)
        loss = (y.float() * cot).sum()
        loss.backward()
        grads = {n: p.grad.float().clone() for n, p in blk.named_parameters()
                 if p.grad is not None}
        grads["x"] = xi.grad.float()
        norm = float(sum(g.square().sum() for g in grads.values()) ** 0.5)
        return y.detach(), loss.item(), grads, norm

    _reset_counts()
    yk, lk, gk, nk = run(True)
    torch.cuda.synchronize()
    counts = _counts()
    yp, lp, gp, np_ = run(False)
    set_use_kernels(blk, True)
    out_ok, out_err, out_atol = _close(yk, yp)
    cos = {n: _cos(gk[n], g) for n, g in gp.items() if g.abs().max() > 0}
    res = {"phase": "flash_block", "card": card, **fb, "route": route,
           "launches": counts, "out_max_abs_err": out_err,
           "out_atol": out_atol, "loss": [lk, lp],
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "grad_norm_rel_err": abs(nk - np_) / np_,
           "grad_cos_min": min(cos.values()),
           "worst_cos": dict(sorted(cos.items(), key=lambda kv: kv[1])[:3])}
    res["ok"] = (route == "non_fused" and out_ok
                 and counts == _want(flash_mha=1, flash_mha_bwd=1,
                                     fused_mlp=1)
                 and res["loss_rel_err"] <= 1e-2
                 and res["grad_norm_rel_err"] <= 2e-2
                 and res["grad_cos_min"] >= 0.99 and set(cos) == set(gp))
    _emit(res)
    if not res["ok"]:
        raise AssertionError(f"flash_block failed its checks: {res}")
    return {"flash_block": counts}


def phase_flash_poison(card: str):
    """Each head's q, k, v and dO sit in rows of dh + 48 columns whose 48
    past dh hold NaN, and each batch in L + 64 rows whose 64 past L hold
    NaN: at head dims 80 and 112 (b=4, h=16, L=257) and at the 336 px
    eval's L = 577 (dh 80, b=2), whose last 64-row query tile holds one
    row and whose last key tile is ragged. The kernels read 128-wide boxes
    through tensor maps that end at dh and at L, so the columns and rows
    past them must load as zero (TMA's out-of-bounds fill). A read of any
    of them turns the outputs NaN; the outputs must also equal those of
    the same inputs copied contiguous, bit for bit."""
    from xtagclip_tpu_torch.ops import flash_attn

    gen = torch.Generator(device="cuda").manual_seed(80)
    h = 16
    res = {}
    for b, l, dh in ((4, 257, 80), (4, 257, 112), (2, EVAL_L, 80)):
        def poisoned():
            full = torch.full((b, l + 64, h, dh + 48), float("nan"),
                              device="cuda", dtype=torch.bfloat16)
            full[:, :l, :, :dh] = torch.randn(
                (b, l, h, dh), generator=gen, device="cuda").to(
                    torch.bfloat16)
            return full[:, :l, :, :dh]

        q, k, v, do = (poisoned() for _ in range(4))
        dense = [t.contiguous() for t in (q, k, v, do)]
        o, lse = flash_attn._flash_fwd(q, k, v, "blhd", with_lse=True)
        got = (o, lse, *flash_attn.flash_mha_bwd(q, k, v, o, lse, do))
        o2, lse2 = flash_attn._flash_fwd(*dense[:3], "blhd", with_lse=True)
        want = (o2, lse2, *flash_attn.flash_mha_bwd(*dense[:3], o2, lse2,
                                                    dense[3]))
        torch.cuda.synchronize()
        res[f"B={b} L={l} dh={dh}"] = {
            "finite": all(bool(torch.isfinite(t).all().item())
                          for t in got),
            "equal_to_contiguous": all(torch.equal(x, y)
                                       for x, y in zip(got, want))}
    result = {"phase": "flash_poison", "card": card,
              "shape": f"H={h}, NaN past dh and past L", "cases": res}
    _emit(result)
    if not all(r["finite"] and r["equal_to_contiguous"] for r in res.values()):
        raise AssertionError(f"flash attention read past the head dim or "
                             f"the sequence: {result}")


def _cosine(a, b):
    a, b = a.float(), b.float()
    return torch.nn.functional.cosine_similarity(a, b, dim=-1)


def _wrappers():
    from xtagclip_tpu_torch.ops import flash_attn, fused_mlp, preprocess
    from xtagclip_tpu_torch.ops import fused_attn_block as fab

    return (fab.fused_attn_half, fab.fused_mlp_half, fab.fused_attn_half_bwd,
            preprocess.normalize_images, fused_mlp.fused_mlp,
            flash_attn.flash_mha, flash_attn.flash_mha_bwd)


def _reset_counts() -> None:
    for w in _wrappers():
        w.launches = 0
        if hasattr(w, "launches_f16"):
            w.launches_f16 = 0


def _counts() -> dict:
    """Each wrapper's launches; flash attention's float16 kernels count
    apart, as ``<wrapper>_f16`` (ops/flash_attn.py)."""
    out = {w.__name__: w.launches for w in _wrappers()}
    out.update({f"{w.__name__}_f16": w.launches_f16 for w in _wrappers()
                if hasattr(w, "launches_f16")})
    return out


def _want(**nonzero) -> dict:
    """Launches of every wrapper: ``nonzero``, and 0 for the rest."""
    out = dict.fromkeys(_counts(), 0)
    out.update(nonzero)
    return out


def _scaled(per, n) -> dict:
    return {k: v * n for k, v in per.items()}


def _paths() -> dict:
    """The two models the serve and train phases drive: their phase-name
    prefix, label, create_model name and overrides, image side, and the
    launches expected per serve batch, per precompute chunk and per train
    step."""
    halves = dict(fused_attn_half=12, fused_mlp_half=12)
    return {
        "b32": dict(
            prefix="", label="ViT-B-32", model="ViT-B-32", kwargs={},
            image=IMAGE_SIZE, per_batch=_want(**halves, normalize_images=1),
            per_chunk=_want(**halves),
            per_step=_want(fused_attn_half=24, fused_mlp_half=24,
                           fused_attn_half_bwd=24, normalize_images=1)),
        "gap": dict(
            prefix="gap_",
            label=f"ViT-B-16 cls-free GAP {GAP_IMAGE_SIZE}px (L={GAP_L})",
            model="ViT-B-16", kwargs={"vision_cfg": GAP_VISION},
            image=GAP_IMAGE_SIZE,
            per_batch=_want(flash_mha=12, fused_mlp=12, normalize_images=1),
            per_chunk=_want(**halves),
            per_step=_want(flash_mha=12, flash_mha_bwd=12, fused_mlp=12,
                           fused_attn_half=12, fused_mlp_half=12,
                           fused_attn_half_bwd=12, normalize_images=1)),
    }


def _serve_batches(side: int):
    """The N_IMAGE_BATCHES seeded host uint8 batches every serve window
    cycles over."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(
        0, 256, (SERVE_BATCH, side, side, 3), dtype=np.uint8))
        for _ in range(N_IMAGE_BATCHES)]


def _scar_prompt_table():
    from xtagclip_tpu_torch.factory import get_tokenizer
    from xtagclip_tpu_torch.tokenize.prompts import PromptTable
    from xtagclip_tpu_torch.train import metadata

    return PromptTable(metadata.SCAR_CLASSNAMES,
                       tokenizer=get_tokenizer("ViT-B-32"),
                       templates=["sentence_1"]).table


def phase_serve_and_path(card: str, path: dict):
    from xtagclip_tpu_torch.factory import cast_for_compute, create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops.preprocess import (
        normalize_images,
        normalize_images_reference,
    )
    from xtagclip_tpu_torch.serving import (
        make_xtag_serve_step,
        precompute_prompt_features,
    )

    t0 = time.perf_counter()
    model = create_model(path["model"], use_tagging=True, use_fusion=True,
                         precision="bf16", init_seed=0, **path["kwargs"])
    cast_for_compute(model, torch.bfloat16)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptable = _scar_prompt_table()
    t_table = time.perf_counter() - t0
    n_prompts = ptable.shape[1] * ptable.shape[2]

    def precompute():
        t0 = time.perf_counter()
        out = precompute_prompt_features(model, ptable, template_id=0,
                                         batch_size=PRECOMPUTE_BATCH)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # main path, part 1: the text tower over every pseudo-prompt, cold
    # (first calls of every op) and then warm
    _reset_counts()
    _, t_pre_cold = precompute()
    table, t_pre = precompute()
    pre_counts = _counts()

    side = path["image"]
    batches = _serve_batches(side)
    serve = make_xtag_serve_step(model, table)

    def serve_one(i, plain=False):
        norm = normalize_images_reference if plain else normalize_images
        images = norm(batches[i % N_IMAGE_BATCHES].to("cuda"),
                      dtype=torch.bfloat16)
        return serve(images)

    # main path, part 2: warm-up batches, then the timed window, each
    # batch from host uint8 to its results on the device
    _reset_counts()
    for i in range(N_WARMUP_BATCHES):
        serve_one(i)
    torch.cuda.synchronize()
    outs, lat = [], []
    t_window = time.perf_counter()
    for i in range(N_SERVE_BATCHES):
        t0 = time.perf_counter()
        outs.append(serve_one(i))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    t_window = time.perf_counter() - t_window
    serve_counts = _counts()

    q = statistics.quantiles(lat, n=100)
    _emit({"phase": path["prefix"] + "serve", "card": card,
           "model": f"{path['label']} xtag bf16", "image_size": side,
           "weights": "seeded random init", "model_build_s": t_model,
           "prompt_table_s": t_table, "prompts": n_prompts,
           "precompute_batch": PRECOMPUTE_BATCH,
           "precompute_cold_s": t_pre_cold, "precompute_s": t_pre,
           "prompts_per_s": n_prompts / t_pre,
           "serve_batch": SERVE_BATCH, "warmup_batches": N_WARMUP_BATCHES,
           "serve_batches": N_SERVE_BATCHES, "window_s": t_window,
           "img_per_s": SERVE_BATCH * N_SERVE_BATCHES / t_window,
           "p50_batch_ms": 1e3 * statistics.median(lat),
           "p90_batch_ms": 1e3 * q[89], "p99_batch_ms": 1e3 * q[98],
           "max_batch_ms": 1e3 * max(lat)})

    n_chunks = math.ceil(n_prompts / PRECOMPUTE_BATCH)
    n_batches = N_WARMUP_BATCHES + N_SERVE_BATCHES
    want_pre = _scaled(path["per_chunk"], 2 * n_chunks)
    want_serve = _scaled(path["per_batch"], n_batches)
    if pre_counts != want_pre or serve_counts != want_serve:
        raise AssertionError(
            f"kernel launches: precompute {pre_counts} (want {want_pre}), "
            f"serve {serve_counts} (want {want_serve})")

    # the same serve through the plain versions of the halves and the
    # normalize
    set_use_kernels(model, False)
    plain = [serve_one(i, plain=True) for i in range(N_IMAGE_BATCHES)]
    rows = torch.from_numpy(ptable[0].reshape(-1, ptable.shape[-1])[:256]
                            .astype(np.int64)).to("cuda")
    with torch.inference_mode():
        plain_rows = model.encode_text(rows)[1].mean(dim=1)
    set_use_kernels(model, True)

    all_feat = torch.cat([o[0] for o in outs])
    all_logits = torch.cat([o[2] for o in outs])
    feat, tags, logits = (torch.cat([o[j] for o in outs[:N_IMAGE_BATCHES]])
                          for j in range(3))
    p_feat, p_tags, p_logits = (torch.cat([o[j] for o in plain])
                                for j in range(3))
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (all_feat, all_logits, table, p_feat, p_logits))
    logit_err = (logits.float() - p_logits.float()).abs().max().item()
    logits_ok = bool(torch.allclose(logits.float(), p_logits.float(),
                                    atol=5e-2, rtol=5e-2))
    cos = _cosine(feat, p_feat).min().item()
    table_cos = _cosine(table.reshape(-1, table.shape[-1])[:256],
                        plain_rows).min().item()
    tag_agree = (tags == p_tags).float().mean().item()
    n_img = SERVE_BATCH * N_IMAGE_BATCHES
    shapes_ok = (tuple(all_logits.shape) == (SERVE_BATCH * N_SERVE_BATCHES, 3)
                 and tuple(tags.shape) == (n_img, 6)
                 and tuple(table.shape) == (3, 2304, 512))
    result = {"phase": path["prefix"] + "path", "card": card,
              "launches_precompute": pre_counts,
              "launches_serve": serve_counts,
              "launches_per_serve_batch": {
                  k: v / (N_WARMUP_BATCHES + N_SERVE_BATCHES)
                  for k, v in serve_counts.items()},
              "logits_max_abs_err": logit_err, "logits_ok": logits_ok,
              "image_feature_cos_min": cos,
              "prompt_table_cos_min": table_cos,
              "tag_agreement": tag_agree, "finite": finite,
              "shapes_ok": shapes_ok}
    _emit(result)
    if not (logits_ok and cos >= 0.999 and table_cos >= 0.999
            and tag_agree >= 0.95 and finite and shapes_ok):
        raise AssertionError(f"kernel path disagrees with plain path: {result}")
    return {"precompute": pre_counts, "serve": serve_counts}, model, \
        ptable, serve_one, table


def _synth_jpegs(n: int, hw, seed: int) -> list:
    """``n`` seeded JPEGs of ``hw`` (smooth noise upscaled, quality 90)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    out = []
    for _ in range(n):
        x = rng.standard_normal((h // 16, w // 16, 3))
        img = Image.fromarray(((x - x.min()) / (np.ptp(x) + 1e-9) * 255)
                              .astype(np.uint8)).resize((w, h),
                                                        Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def phase_decode_serve(card: str, model, table) -> dict:
    """The ViT-B-32 serve path with its host decode stage, as JAX's
    headline runs it (bench.py:473-542): one batch of SERVE_BATCH seeded
    480 x 640 JPEGs through ``data/native.py::decode_square_batch`` (on
    the route the machine has: PIL without libjpeg's headers), the padded
    squares to the card, ``resize_crop_normalize`` there with sizes
    ``np.stack([sides, sides], 1)`` (no #5: the resize normalizes), then
    the serve step; one warm-up and DECODE_REPS timed batches (decode
    img/s, end-to-end img/s). The serve outputs against the plain halves'
    on the same images at phase 4's bars. Returns the timed batches'
    launches."""
    from xtagclip_tpu_torch.data import native
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops.preprocess import resize_crop_normalize
    from xtagclip_tpu_torch.serving import make_xtag_serve_step

    jpegs = _synth_jpegs(SERVE_BATCH, DECODE_SIDE_HW, seed=3)
    serve = make_xtag_serve_step(model, table)
    dec_s = []

    def one():
        t0 = time.perf_counter()
        u8, sides = native.decode_square_batch(jpegs, IMAGE_SIZE)
        dec_s.append(time.perf_counter() - t0)
        sizes = np.stack([sides, sides], 1)
        images = resize_crop_normalize(
            torch.from_numpy(u8).to("cuda"), torch.from_numpy(sizes).to(
                "cuda"), out_size=IMAGE_SIZE, dtype=torch.bfloat16)
        return images, sides, u8.shape[1], serve(images)

    images, sides, slab, _ = one()
    torch.cuda.synchronize()
    dec_s.clear()
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(DECODE_REPS):
        _, _, _, out = one()
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    counts = _counts()
    set_use_kernels(model, False)
    plain = serve(images)
    set_use_kernels(model, True)
    feat, tags, logits = out
    p_feat, p_tags, p_logits = plain
    res = {"phase": "decode_serve", "card": card, "model": "ViT-B-32 xtag",
           "jpegs": SERVE_BATCH, "jpeg_hw": list(DECODE_SIDE_HW),
           "decode_route": native.decode_route(),
           "square_sides": sorted(set(int(v) for v in sides)),
           "slab_side": int(slab),
           "decode_img_per_s": SERVE_BATCH * DECODE_REPS / sum(dec_s),
           "end_to_end_img_per_s": SERVE_BATCH * DECODE_REPS / t_all,
           "launches": counts,
           "logits_max_abs_err": (logits.float() - p_logits.float()).abs()
           .max().item(),
           "image_feature_cos_min": _cosine(feat, p_feat).min().item(),
           "tag_agreement": (tags == p_tags).float().mean().item()}
    res["ok"] = (bool(torch.allclose(logits.float(), p_logits.float(),
                                     atol=5e-2, rtol=5e-2))
                 and res["image_feature_cos_min"] >= 0.999
                 and res["tag_agreement"] >= 0.95
                 and bool(torch.isfinite(logits.float()).all())
                 and min(sides) > 0
                 and counts == _scaled(_want(fused_attn_half=12,
                                             fused_mlp_half=12), DECODE_REPS))
    _emit(res)
    if not res["ok"]:
        raise AssertionError(f"decode_serve failed its checks: {res}")
    return counts


def phase_multi_step(card: str, ptable) -> dict:
    """``train/loop.py::make_multi_step`` on the ViT-B-32 XTag step at
    batch TRAIN_BATCH: MULTI_STEPS steps over stacked batches (their uint8
    images normalized by #5, as train/trainer.py does) in one call,
    against MULTI_STEPS calls of ``make_train_step`` from the same weights
    on the same batches and dropout generator seed: every parameter, the
    AdamW state and the stacked metrics bit for bit equal; then one more
    call timed (samples/s). Returns the first call's launches."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.train.loop import make_multi_step, make_train_step

    model = create_model("ViT-B-32", use_tagging=True, use_fusion=True,
                         precision="bf16", init_seed=0)
    twin = copy.deepcopy(model)
    table = torch.from_numpy(ptable.astype(np.int64)).to("cuda")
    host = _train_batches(ptable)[:MULTI_STEPS]
    keys = ("class_ids", "additional")
    state = _new_train_state(model)
    multi = make_multi_step({}, MULTI_STEPS, prompt_table=table)
    _reset_counts()
    batches = [_device_batch(h, keys) for h in host]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    state, metrics = multi(state, stacked,
                           torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    counts = _counts()
    seq = _new_train_state(twin)
    step = make_train_step({}, prompt_table=table)
    gen = torch.Generator(device="cuda").manual_seed(0)
    want = []
    for b in batches:
        seq, m = step(seq, b, gen)
        want.append(m)
    params_equal = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), twin.state_dict().values()))
    opt_a, opt_b = (st.tx.optimizer.state_dict()["state"]
                    for st in (state, seq))
    opt_equal = opt_a.keys() == opt_b.keys() and all(
        torch.equal(v, opt_b[i][k]) if torch.is_tensor(v) else v == opt_b[i][k]
        for i, leaf in opt_a.items() for k, v in leaf.items())
    metrics_equal = set(metrics) == set(want[0]) and all(
        torch.equal(v, torch.stack([m[k] for m in want]))
        for k, v in metrics.items())
    t0 = time.perf_counter()
    state, _ = multi(state, stacked,
                     torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res = {"phase": "multi_step", "card": card,
           "model": "ViT-B-32 xtag bf16 over fp32 masters",
           "batch": TRAIN_BATCH, "steps": MULTI_STEPS,
           "step_after": [state.step, seq.step], "launches": counts,
           "params_bit_equal": params_equal, "adamw_bit_equal": opt_equal,
           "metrics_bit_equal": metrics_equal,
           "losses": metrics["loss"].tolist(),
           "samples_per_s": TRAIN_BATCH * MULTI_STEPS / dt}
    res["ok"] = (params_equal and opt_equal and metrics_equal
                 and seq.step == MULTI_STEPS and state.step == 2 * MULTI_STEPS
                 and all(math.isfinite(v) for v in res["losses"])
                 and counts == _scaled(_paths()["b32"]["per_step"],
                                       MULTI_STEPS))
    _emit(res)
    if not res["ok"]:
        raise AssertionError(f"multi_step failed its checks: {res}")
    return counts


def _train_batches(ptable, side: int = IMAGE_SIZE):
    """N_TRAIN_BATCHES seeded host batches: uint8 images, class ids in
    [0, 3), one tag per category as a [B, 22] multi-hot, and the
    ground-truth prompt (the class's prompt for the batch's own tags)."""
    from xtagclip_tpu_torch.models.clip import (
        NUM_TAGS,
        TAG_CATEGORY_OFFSETS,
        TAG_CATEGORY_SIZES,
        combo_index,
    )

    out = []
    for i in range(N_TRAIN_BATCHES):
        rng = np.random.default_rng(100 + i)
        images = rng.integers(0, 256, (TRAIN_BATCH, side, side, 3),
                              dtype=np.uint8)
        class_ids = rng.integers(0, 3, TRAIN_BATCH)
        local = np.stack([rng.integers(0, n, TRAIN_BATCH)
                          for n in TAG_CATEGORY_SIZES], axis=1)
        additional = np.zeros((TRAIN_BATCH, NUM_TAGS), np.float32)
        np.put_along_axis(additional,
                          local + np.asarray(TAG_CATEGORY_OFFSETS), 1.0, axis=1)
        combo = combo_index(torch.from_numpy(local)).numpy()
        texts = ptable[0, class_ids, combo].astype(np.int64)
        out.append({"images": torch.from_numpy(images),
                    "class_ids": torch.from_numpy(class_ids),
                    "additional": torch.from_numpy(additional),
                    "texts": torch.from_numpy(texts)})
    return out


def _device_batch(host, keys, plain=False, dtype=torch.bfloat16):
    """A host batch on the card, its uint8 images normalized there to
    ``dtype`` (by the kernel, or by its plain version)."""
    from xtagclip_tpu_torch.ops import preprocess

    norm = (preprocess.normalize_images_reference if plain
            else preprocess.normalize_images)
    batch = {"images": norm(host["images"].to("cuda"), dtype=dtype)}
    for k in keys:
        batch[k] = host[k].to("cuda")
    return batch


def _new_train_state(model, opt: str = "adamw", schedule=None):
    """The recipe's ``--opt opt`` (betas (0.9, 0.98), eps 1e-6, wd 0.1) over
    ``model``, on ``schedule`` (default: the recipe's warmup + cosine)."""
    from xtagclip_tpu_torch.train.scheduler import cosine_lr
    from xtagclip_tpu_torch.train.train_state import (
        create_train_state,
        make_optimizer,
    )

    schedule = schedule or cosine_lr(TRAIN_LR, TRAIN_WARMUP,
                                     TRAIN_SCHEDULE_STEPS)
    return create_train_state(model, make_optimizer(
        schedule, beta1=0.9, beta2=0.98, eps=1e-6, weight_decay=TRAIN_WD,
        params=dict(model.named_parameters()), opt=opt))


def phase_train(card: str, ptable, path: dict):
    """Main path, part 3: the XTag train step, warm-up then a timed
    window, counting the kernel launches of every step."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.train.loop import make_train_step

    model = create_model(path["model"], use_tagging=True, use_fusion=True,
                         precision="bf16", init_seed=0, **path["kwargs"])
    n_params = sum(p.numel() for p in model.parameters())
    state = _new_train_state(model)
    step = make_train_step({}, prompt_table=torch.from_numpy(
        ptable.astype(np.int64)).to("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    host = _train_batches(ptable, path["image"])
    keys = ("class_ids", "additional")

    def train_one(i):
        nonlocal state
        state, m = step(state, _device_batch(host[i % N_TRAIN_BATCHES], keys),
                        gen)
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics = [train_one(i) for i in range(N_TRAIN_WARMUP)]
    torch.cuda.synchronize()
    lat = []
    t_window = time.perf_counter()
    for i in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(train_one(N_TRAIN_WARMUP + i))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    t_window = time.perf_counter() - t_window
    counts = _counts()
    n_steps = N_TRAIN_WARMUP + N_TRAIN_STEPS
    vals = [{k: v.item() for k, v in m.items()} for m in metrics]
    finite = all(math.isfinite(v) for m in vals for v in m.values())
    keys_ok = all(set(m) == {"contrastive_loss", "tagging_loss", "ce_loss",
                             "loss", "logit_scale", "grad_norm"}
                  for m in vals)
    per_step = {k: v / n_steps for k, v in counts.items()}
    q = statistics.quantiles(lat, n=10)
    result = {"phase": path["prefix"] + "train", "card": card,
              "model": f"{path['label']} xtag bf16 over fp32 masters",
              "image_size": path["image"],
              "weights": "seeded random init", "params": n_params,
              "batch": TRAIN_BATCH, "warmup_steps": N_TRAIN_WARMUP,
              "steps": N_TRAIN_STEPS, "window_s": t_window,
              "samples_per_s": TRAIN_BATCH * N_TRAIN_STEPS / t_window,
              "p50_step_ms": 1e3 * statistics.median(lat),
              "p90_step_ms": 1e3 * q[8], "max_step_ms": 1e3 * max(lat),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "loss_first": vals[0]["loss"], "loss_last": vals[-1]["loss"],
              "first_step": vals[0], "last_step": vals[-1],
              "grad_norm_first": vals[0]["grad_norm"],
              "grad_norm_last": vals[-1]["grad_norm"],
              "finite": finite, "launches": counts,
              "launches_per_step": per_step}
    _emit(result)
    if not (finite and keys_ok and per_step == path["per_step"]):
        raise AssertionError(f"train step failed its checks: {result}")
    return counts, train_one


# Parameters whose exact gradient is 0, left out of the gradient check: a
# key bias adds one constant to each query's scores, which the softmax
# removes, so both sides hold rounding noise only: the tag head's, and
# CoCa's attentional pooler's (its own k_proj; a fused in_proj's bias
# holds the q and v biases beside it)
ZERO_GRAD_PARAMS = ("crossattention.key.bias", "attn_pool.attn.k_proj.bias")


def _bf16_ulp_shift(x, steps: int):
    """x (bf16, or float16) with every element ``steps`` steps of its
    dtype further from zero (nearer for a negative ``steps``; zeros move
    up)."""
    bits = x.view(torch.int16)
    moved = torch.where(bits & 0x7FFF == 0, bits + abs(steps), bits + steps)
    return moved.view(x.dtype)


def _cos(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()


def _dist(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _steps_vs_plain(runs, step, plain, start, seed: int = 1) -> dict:
    """{run name: (metrics, {parameter: gradient})} of one step of each of
    ``runs`` ((name, model, batch), ...): each from a new train state, the
    dropout generator seeded with ``seed``, the ``plain`` model reloaded
    with ``start`` first."""
    out = {}
    for name, model, b in runs:
        if model is plain:
            plain.load_state_dict(start)
        state = _new_train_state(model)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        _, m = step(state, b, gen)
        torch.cuda.synchronize()
        out[name] = ({k: v.item() for k, v in m.items()},
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        model.zero_grad(set_to_none=True)
    return out


def _judge_steps(out) -> dict:
    """The train-path bars on ``_steps_vs_plain``'s kernels, plain,
    plain_up and plain_down runs (see phase_train_path): the fields of the
    printed result, with ``ok``."""
    (mk, gk), (mp, gp) = out["kernels"], out["plain"]
    names = [n for n in gp if gp[n].abs().max().item() > 0
             and not any(z in n for z in ZERO_GRAD_PARAMS)]
    cos = {n: _cos(gk[n], gp[n]) for n in names}
    under = {}
    for n in names:
        if cos[n] >= 0.99:
            continue
        floor = max(_dist(out[k][1][n], gp[n]) for k in ("plain_up",
                                                          "plain_down"))
        under[n] = {"cos": cos[n], "dist": _dist(gk[n], gp[n]),
                    "noise_dist": floor}
    failed = [n for n, v in under.items()
              if v["cos"] < 0.95 or v["dist"] > 2 * v["noise_dist"]]
    loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    norm_rel = abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
    finite = all(math.isfinite(v) for m in (mk, mp) for v in m.values())
    worst = sorted(under.items(), key=lambda kv: kv[1]["cos"])[:8]
    res = {"kernels": mk, "plain": mp,
           "loss_rel_err": loss_rel, "grad_norm_rel_err": norm_rel,
           "grads_compared": len(names),
           "grads_missing": sorted(set(gp) - set(gk)),
           "zero_grad_params_max_abs": {
               n: [gk[n].abs().max().item(), gp[n].abs().max().item()]
               for n in gp if any(z in n for z in ZERO_GRAD_PARAMS)},
           "grad_cos_min": min(cos.values()),
           "grads_cos_at_least_0.99": len(names) - len(under),
           "grads_under_0.99": len(under),
           "worst_under_0.99": dict(worst),
           "max_dist_over_noise": max(
               (v["dist"] / v["noise_dist"] if v["noise_dist"] else math.inf
                for v in under.values()), default=0.0),
           "grads_failed": failed, "finite": finite}
    res["ok"] = (loss_rel <= 1e-2 and norm_rel <= 2e-2 and not failed
                 and finite and not res["grads_missing"])
    return res, names


def phase_train_path(card: str, ptable, path: dict):
    """One step with the kernels on and off from the same weights, batch
    and dropout seed, on the batch's ground-truth prompts (the argmax
    prompt gather is discontinuous: bf16 ties flip a few picks).

    The plain step run again on images one bf16 step up and one step down
    gives each parameter gradient its own bf16 noise floor: the gradients
    that reach the text tower and TQN through the DQNCOS loss move to a
    cosine of 0.984-0.99 under that one-ULP change of the input (an
    NVIDIA H100 80GB HBM3 at 700 W), below a 0.99 bar. A gradient passes at cosine >= 0.99, or at
    cosine >= 0.95 when the kernels move it no further than twice the
    larger one-ULP move. An fp32 step from the same weights is printed
    beside them: how far each bf16 path lies from it, tower by tower."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.train.loop import make_train_step

    kernels = create_model(path["model"], use_tagging=True, use_fusion=True,
                           precision="bf16", init_seed=1, **path["kwargs"])
    plain = copy.deepcopy(kernels)
    set_use_kernels(plain, False)
    fp32 = create_model(path["model"], use_tagging=True, use_fusion=True,
                        precision="fp32", init_seed=1, **path["kwargs"])
    host = _train_batches(ptable, path["image"])[0]
    batch = _device_batch(host, ("additional", "texts"))
    p_batch = _device_batch(host, ("additional", "texts"), plain=True)
    start = copy.deepcopy(plain.state_dict())
    runs = (("kernels", kernels, batch), ("plain", plain, p_batch),
            ("plain_up", plain, dict(p_batch, images=_bf16_ulp_shift(
                p_batch["images"], 1))),
            ("plain_down", plain, dict(p_batch, images=_bf16_ulp_shift(
                p_batch["images"], -1))),
            ("fp32", fp32, dict(p_batch, images=p_batch["images"].float())))
    out = _steps_vs_plain(runs, make_train_step({}), plain, start)
    judged, names = _judge_steps(out)

    def tower_cos(g):
        ref = out["fp32"][1]
        res = {}
        for tower in ("visual", "text", "tag_head", "fusion_model"):
            ks = [n for n in names if n.startswith(tower + ".")]
            res[tower] = _cos(torch.cat([g[n].float().flatten() for n in ks]),
                              torch.cat([ref[n].float().flatten() for n in ks]))
        return res

    ok = judged.pop("ok")
    result = {"phase": path["prefix"] + "train_path", "card": card,
              "model": path["label"], "texts": "ground truth",
              "fp32": out["fp32"][0], **judged,
              "cos_to_fp32_kernels": tower_cos(out["kernels"][1]),
              "cos_to_fp32_plain": tower_cos(out["plain"][1])}
    _emit(result)
    if not ok:
        raise AssertionError(f"kernel train step disagrees with plain: "
                             f"{result}")


def phase_fp16(card: str, ptable) -> dict:
    """fp16 (module doc): the GAP ViT-B-16 XTag model at 256 px in
    ``pure_fp16``, one serve batch of 32 and one train step of 32, each
    against the plain route (use_kernels off, the plain normalize) at
    phases 4 and 6's bars. Its vision blocks' cores run #6's float16
    kernels (12 forwards a batch; 12 forwards and 12 backwards a step);
    nothing else launches a kernel but #5, whose fp32 output one cast
    rounds to float16: #1-#4 and #6's bf16 kernels never. Returns the
    launches."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops import preprocess
    from xtagclip_tpu_torch.serving import (
        make_xtag_serve_step,
        precompute_prompt_features,
    )
    from xtagclip_tpu_torch.train.loop import make_train_step

    f16, path = torch.float16, _paths()["gap"]
    model = create_model(path["model"], use_tagging=True, use_fusion=True,
                         precision="pure_fp16", init_seed=1,
                         **path["kwargs"])
    plain = copy.deepcopy(model)
    set_use_kernels(plain, False)
    start = copy.deepcopy(plain.state_dict())
    # the serve batch (the prompt table: the text tower's float16 route
    # is the plain one, kernels on or off)
    _reset_counts()
    with torch.inference_mode():
        table = precompute_prompt_features(model, ptable, template_id=0,
                                           batch_size=PRECOMPUTE_BATCH)
        pre_counts = _counts()
        u8 = _serve_batches(GAP_IMAGE_SIZE)[0].to("cuda")
        _reset_counts()
        feat, tags, logits = make_xtag_serve_step(model, table)(
            preprocess.normalize_images(u8, dtype=f16))
        torch.cuda.synchronize()
        serve_counts = _counts()
        p_feat, p_tags, p_logits = make_xtag_serve_step(plain, table)(
            preprocess.normalize_images_reference(u8, dtype=f16))
    serve = {
        "launches_precompute": pre_counts, "launches_serve": serve_counts,
        "logits_max_abs_err": (logits.float()
                               - p_logits.float()).abs().max().item(),
        "logits_ok": bool(torch.allclose(logits.float(), p_logits.float(),
                                         atol=5e-2, rtol=5e-2)),
        "image_feature_cos_min": _cosine(feat, p_feat).min().item(),
        "tag_agreement": (tags == p_tags).float().mean().item(),
        "finite": all(bool(torch.isfinite(t.float()).all())
                      for t in (feat, logits, table, p_feat, p_logits)),
        "dtypes": sorted({str(t.dtype) for t in (feat, logits, table)})}
    serve["ok"] = (serve["logits_ok"] and serve["image_feature_cos_min"]
                   >= 0.999 and serve["tag_agreement"] >= 0.95
                   and serve["finite"] and pre_counts == _want()
                   and serve_counts == _want(flash_mha_f16=12,
                                             normalize_images=1))
    # the train step, kernels on against the plain route (and the plain
    # step on images one float16 step up and down: each gradient's noise
    # floor, as phase 6)
    host = _train_batches(ptable, GAP_IMAGE_SIZE)[0]
    batch = _device_batch(host, ("additional", "texts"), dtype=f16)
    p_batch = _device_batch(host, ("additional", "texts"), plain=True,
                            dtype=f16)
    step = make_train_step({})
    _reset_counts()
    out = _steps_vs_plain((("kernels", model, batch),), step, plain, start)
    step_counts = _counts()
    out.update(_steps_vs_plain((
        ("plain", plain, p_batch),
        ("plain_up", plain, dict(p_batch, images=_bf16_ulp_shift(
            p_batch["images"], 1))),
        ("plain_down", plain, dict(p_batch, images=_bf16_ulp_shift(
            p_batch["images"], -1)))), step, plain, start))
    train, _ = _judge_steps(out)
    train["launches_step"] = step_counts
    train["ok"] = train["ok"] and step_counts == _want(
        flash_mha_f16=12, flash_mha_bwd_f16=12)
    result = {"phase": "fp16", "card": card,
              "model": f"{path['label']} xtag pure_fp16",
              "batch": SERVE_BATCH, "serve": serve, "train_path": train,
              "ok": serve["ok"] and train["ok"]}
    _emit(result)
    if not result["ok"]:
        raise AssertionError(f"fp16 phase failed its checks: {result}")
    del model, plain
    # the scar CLI at --precision pure_fp16: one epoch, its eval and its
    # checkpoints (phase 9's checks, float16's launches)
    cli = phase_gap_trainer(card, "pure_fp16", FP16_TRAINER_ROWS,
                            "fp16_trainer")
    return {"serve": serve_counts, "train": step_counts, "trainer": cli}


def phase_intermediates(card: str, ptable) -> dict:
    """intermediates (module doc): ``forward_intermediates`` of the
    ViT-B-32 XTag model and the GAP tower in bf16, every block of both
    towers (NCHW image grids), with the logits, on a serve batch of 32
    images and 32 scar prompts: its final features bit-equal to
    ``encode_image`` / ``encode_text`` on the same route, its launches
    one forward's (the fused halves; the GAP tower's #6 and #4), and
    every intermediate, feature and logit held to the plain route (the
    same call with use_kernels off, the plain normalize) at the serve
    bar: cosine >= 0.999 a sample, logits within 5e-2. Returns the
    launches."""
    from xtagclip_tpu_torch.factory import cast_for_compute, create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops import preprocess

    bf = torch.bfloat16
    texts = torch.from_numpy(ptable[0, 0, :SERVE_BATCH].astype(
        np.int64)).to("cuda")
    result = {"phase": "intermediates", "card": card}
    launches = {}
    wants = {"b32": _want(fused_attn_half=24, fused_mlp_half=24),
             "gap": _want(flash_mha=12, fused_mlp=12, fused_attn_half=12,
                          fused_mlp_half=12)}
    for key in ("b32", "gap"):
        path = _paths()[key]
        model = create_model(path["model"], use_tagging=True,
                             use_fusion=True, precision="bf16", init_seed=0,
                             **path["kwargs"])
        cast_for_compute(model, bf)
        u8 = _serve_batches(path["image"])[0].to("cuda")
        grid = path["image"] // model.visual.patch_size[0]
        with torch.inference_mode():
            images = preprocess.normalize_images(u8, dtype=bf)
            _reset_counts()
            out = model.forward_intermediates(images, texts,
                                              output_logits=True)
            torch.cuda.synchronize()
            counts = _counts()
            img, _ = model.encode_image(images, normalize=True)
            txt, _ = model.encode_text(texts, normalize=True)
            set_use_kernels(model, False)
            ref = model.forward_intermediates(
                preprocess.normalize_images_reference(u8, dtype=bf), texts,
                output_logits=True)
            set_use_kernels(model, True)
        cos = {k: min(_cosine(a.flatten(1), b.flatten(1)).min().item()
                      for a, b in zip(out[k], ref[k]))
               for k in ("image_intermediates", "text_intermediates")}
        cos.update({k: _cosine(out[k], ref[k]).min().item()
                    for k in ("image_features", "text_features")})
        rec = {"model": path["label"], "launches": counts,
               "blocks": [len(out["image_intermediates"]),
                          len(out["text_intermediates"])],
               "image_grid": list(out["image_intermediates"][0].shape),
               "features_equal_encode": bool(
                   torch.equal(out["image_features"], img)
                   and torch.equal(out["text_features"], txt)),
               "cos_min": cos,
               "logits_max_abs_err": (out["image_logits"]
                                      - ref["image_logits"]).abs().max()
               .item(),
               "logits_ok": bool(torch.allclose(
                   out["image_logits"], ref["image_logits"], atol=5e-2,
                   rtol=5e-2)),
               "finite": all(bool(torch.isfinite(t.float()).all()) for t in
                             out["image_intermediates"]
                             + out["text_intermediates"])}
        rec["ok"] = (rec["features_equal_encode"] and rec["logits_ok"]
                     and rec["finite"] and min(cos.values()) >= 0.999
                     and counts == wants[key] and rec["blocks"] == [12, 12]
                     and rec["image_grid"] == [SERVE_BATCH, model.visual.width,
                                             grid, grid])
        result[key] = rec
        launches[key] = counts
        del model
    result["ok"] = result["b32"]["ok"] and result["gap"]["ok"]
    _emit(result)
    if not result["ok"]:
        raise AssertionError(f"intermediates phase failed its checks: "
                             f"{result}")
    return launches


# the scar label vocabulary (label_info.json) of the reference data
SCAR_LABEL_INFO = {
    "Width": ["Linear", "Widened", "Linear bulging"],
    "Color": ["Normal", "Pink", "Red", "Purple"],
    "Pigmentation": ["Normal", "Pigmented", "Hypopigmented"],
    "Surface": ["Flat", "Hypertrophic", "Keloid", "Atrophic"],
    "Irregular_color": ["no", "mild", "moderate", "severe"],
    "Irregular_height": ["no", "mild", "moderate", "severe"],
}
TRAINER_ROWS = {"scar_train": 256, "scar_val": 96}
TRAINER_IMAGE = 240  # the PNG side; both transforms crop IMAGE_SIZE
TRAINER_WORKERS = 4
TRAINER_EPOCHS = 2  # plain steps; then one epoch of the accumulation step
TRAINER_ACCUM = 2
ARTIFACTS = ("val_data_tagging_output.txt", "val_data_class_output.txt",
             "traindata_val_tagging_output.txt",
             "traindata_val_class_output.txt")
GAP_TRAINER_ROWS = {"scar_train": 64, "scar_val": 32}
GAP_TRAINER_IMAGE = 272  # the PNG side; both transforms crop GAP_IMAGE_SIZE


def _write_scar_split(root, rows: int, rng, side: int = TRAINER_IMAGE) -> str:
    """A scar split in the reference's layout: label_info.json, seeded
    random PNG images and a labels.csv (Name, Class, Use and the six
    attribute columns)."""
    from PIL import Image

    os.makedirs(root)
    with open(os.path.join(root, "label_info.json"), "w") as f:
        json.dump(SCAR_LABEL_INFO, f)
    lines = ["Name,Class,Use," + ",".join(SCAR_LABEL_INFO)]
    for i in range(rows):
        name = f"scar_{i:04d}.png"
        Image.fromarray(rng.integers(
            0, 256, (side, side, 3), dtype=np.uint8)).save(
                os.path.join(root, name), compress_level=1)
        attrs = [v[rng.integers(0, len(v))] for v in SCAR_LABEL_INFO.values()]
        lines.append(f"{name},{rng.integers(1, 4)},yes," + ",".join(attrs))
    path = os.path.join(root, "labels.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _loader_item_ms(root, csv_file, n: int = 64) -> dict:
    """Host ms of one train item, on one thread with nothing else running:
    all of ScarDataset.__getitem__, and its PNG decode + crop alone."""
    from xtagclip_tpu_torch.data.scar import ScarDataset
    from xtagclip_tpu_torch.data.transforms import (
        PreprocessCfg,
        image_transform_train,
    )
    from xtagclip_tpu_torch.factory import get_tokenizer

    ds = ScarDataset(root, csv_file=csv_file, tokenizer=get_tokenizer(
        "ViT-B-32"), transform=image_transform_train(PreprocessCfg(
            size=IMAGE_SIZE)))
    n = min(n, len(ds))
    ds[0]
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    item = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for i in range(n):
        ds.transform(ds.loader(ds.imgs[i]))
    image = (time.perf_counter() - t0) / n
    return {"item": 1e3 * item, "decode_and_crop": 1e3 * image,
            "rest (5 GT prompts tokenized, labels)": 1e3 * (item - image)}


@contextlib.contextmanager
def _probed(targets, log, check=None):
    """Wrap each ``(module, name)`` function for the block: every call
    appends its name, seconds, kernel launches and result to ``log``
    (the launches are read, not counted here), and ``check[name](args,
    result)``, when given, right after the call."""
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            before, t0 = _counts(), time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            after = _counts()
            log.append({"what": _name, "s": time.perf_counter() - t0,
                        "launches": {w: after[w] - before[w] for w in after},
                        "out": out, "call": len(log),
                        "check": (check or {}).get(_name, lambda *_: None)(
                            a, out)})
            return out

        setattr(mod, name, wrapped)
        saved.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _per(calls, n):
    """Launches per unit, summed over ``calls`` and divided by ``n``."""
    tot = {}
    for c in calls:
        for k, v in c["launches"].items():
            tot[k] = tot.get(k, 0) + v
    return {k: v / n for k, v in tot.items()}


def _same_state(a, b) -> bool:
    """Bit for bit: parameters, AdamW moments and step counts, update
    count."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if sa.keys() != sb.keys() or a.step != b.step:
        return False
    if not all(torch.equal(sa[k], sb[k]) for k in sa):
        return False
    oa = a.tx.optimizer.state_dict()["state"]
    ob = b.tx.optimizer.state_dict()["state"]
    return oa.keys() == ob.keys() and all(
        oa[i].keys() == ob[i].keys()
        and all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i]) for i in oa)


def phase_trainer(card: str, keep_tag: str, profile: bool = False):
    """Main path, part 4: the scar training CLI, ``main_other.main``, as a
    user runs it (the recipe of scar_openclip_pretrain.sh at batch 32):
    seeded PNG files through ScarDataset, the train and eval transforms
    and the threaded loader; TRAINER_EPOCHS epochs of the plain step with
    the scar eval after each and the four best checkpoints, then a second
    call with --resume latest that reloads the state and runs one epoch of
    the accumulation step. Returns the launches of both calls, and keeps
    the last checkpoint tag (hard links) at ``keep_tag``. With
    ``profile``, the second plain epoch (loader included) runs inside a
    torch.profiler window, which slows its host side."""
    from xtagclip_tpu_torch.cli import main_other
    from xtagclip_tpu_torch.train import checkpoint, zero_shot
    from xtagclip_tpu_torch.train.logger import close_logging

    train_one_epoch = main_other.train_one_epoch
    epoch_calls = []

    def profiled_epoch(*a, **k):
        epoch_calls.append(None)
        if len(epoch_calls) != TRAINER_EPOCHS:
            return train_one_epoch(*a, **k)
        out = []
        _profile_window(
            f"trainer epoch {TRAINER_EPOCHS}: "
            f"{TRAINER_ROWS['scar_train'] // TRAIN_BATCH} plain steps of "
            f"{TRAIN_BATCH} with the loader",
            lambda: out.append(train_one_epoch(*a, **k)), card)
        return out[0]

    log, first_state = [], {}
    # the state --resume latest restored, held to the one the first call
    # saved, before the second call trains it further
    check = {"restore_train_state": lambda a, out: _same_state(
        a[2], first_state["state"])}
    targets = ((main_other, "train_one_epoch"), (zero_shot, "run_scar_eval"),
               (zero_shot, "build_zero_shot_classifier"),
               (checkpoint, "save_train_state"),
               (main_other, "restore_train_state"))
    with tempfile.TemporaryDirectory(prefix="xtag_trainer_") as tmp:
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        csvs = {split: _write_scar_split(os.path.join(tmp, split), n, rng)
                for split, n in TRAINER_ROWS.items()}
        t_data = time.perf_counter() - t0
        logs = os.path.join(tmp, "logs")
        common = [
            "--model", "ViT-B-32", "--use-tagging", "--use-fusion",
            "--train-data", os.path.join(tmp, "scar_train"),
            "--val-data", os.path.join(tmp, "scar_val"),
            "--scar-train-csv", csvs["scar_train"],
            "--scar-val-csv", csvs["scar_val"],
            "--batch-size", str(TRAIN_BATCH), "--workers",
            str(TRAINER_WORKERS), "--precision", "amp", "--lr",
            str(TRAIN_LR), "--wd", str(TRAIN_WD), "--warmup",
            str(TRAIN_WARMUP), "--prompt-template-setting", "total",
            "--logs", logs, "--name", "trainer", "--log-every-n-steps", "1",
            "--zeroshot-frequency", "1", "--save-best",
            "--delete-previous-checkpoint", "--seed", "0"]
        _reset_counts()
        t0 = time.perf_counter()
        if profile:
            main_other.train_one_epoch = profiled_epoch
        try:
            with _probed(targets, log, check):
                first = main_other.main(common + ["--epochs",
                                                  str(TRAINER_EPOCHS)])
                first_state["state"] = first["state"]
                n_first = len(log)
                second = main_other.main(common + [
                    "--epochs", str(TRAINER_EPOCHS + 1), "--resume", "latest",
                    "--accum-freq", str(TRAINER_ACCUM)])
        finally:
            main_other.train_one_epoch = train_one_epoch
            close_logging()
        t_run = time.perf_counter() - t0
        counts = _counts()
        ckpt_dir = os.path.join(logs, "trainer", "checkpoints")
        listing = sorted(os.listdir(ckpt_dir))
        missing = [a for a in ARTIFACTS + (
            f"epoch_{TRAINER_EPOCHS + 1}", "epoch_latest", "last",
            "best_train_top1", "best_train_loss", "best_val_top1",
            "best_tag_acc") if a not in listing]
        stale = [f"epoch_{e}" for e in range(1, TRAINER_EPOCHS + 1)
                 if f"epoch_{e}" in listing]
        loader_ms = _loader_item_ms(os.path.join(tmp, "scar_train"),
                                    csvs["scar_train"])
        restores = [c for c in log if c["what"] == "restore_train_state"]
        reload_exact = len(restores) == 1 and restores[0]["check"] is True
        resumed_epoch = restores[0]["out"] if restores else None
        shutil.copytree(os.path.join(ckpt_dir, "last"), keep_tag,
                        copy_function=os.link)

    epochs = first["epochs"] + second["epochs"]
    trains = [c for c in log if c["what"] == "train_one_epoch"]
    evals = [c for c in log if c["what"] == "run_scar_eval"]
    builds = [c for c in log if c["what"] == "build_zero_shot_classifier"]
    saves = [c["s"] for c in log if c["what"] == "save_train_state"]
    plain_trains = [c for c in trains if c["call"] < n_first]
    accum_trains = [c for c in trains if c["call"] >= n_first]
    steps_per_epoch = TRAINER_ROWS["scar_train"] // TRAIN_BATCH
    eval_images = sum(c["out"]["n"] for c in evals)
    eval_batches = sum(math.ceil(c["out"]["n"] / TRAIN_BATCH) for c in evals)
    per_epoch = []
    for rec, call in zip(epochs, trains):
        tm, ev = rec["train"], rec["eval"]
        per_epoch.append({
            "epoch": rec["epoch"],
            "step": "plain" if call["call"] < n_first else "accum",
            "samples_per_s": tm["samples_per_second"],
            "p50_step_ms": 1e3 * tm["p50_step_s"],
            "loss": tm["loss"], "contrastive_loss": tm["contrastive_loss"],
            "tagging_loss": tm["tagging_loss"],
            **({"ce_loss": tm["ce_loss"]} if "ce_loss" in tm else {}),
            "eval_s": rec["eval_s"], "checkpoint_s": rec["checkpoint_s"],
            "eval": {k: ev[k] for k in sorted(ev) if k.endswith((
                "top1", "top2", "tag_accuracy", "tag_f1", "-n"))}})
    values = [v for e in per_epoch for v in (
        e["loss"], e["samples_per_s"], e["p50_step_ms"],
        *e["eval"].values())]
    finite = all(math.isfinite(v) for v in values)
    falling = per_epoch[TRAINER_EPOCHS - 1]["loss"] < per_epoch[0]["loss"]
    per_plain_step = _per(plain_trains, steps_per_epoch * len(plain_trains))
    per_accum_step = _per(accum_trains, steps_per_epoch * len(accum_trains))
    per_eval_batch = _per(evals, eval_batches)
    per_build = _per(builds, len(builds))
    result = {
        "phase": "trainer", "card": card,
        "entry": "xtagclip_tpu_torch.cli.main_other.main, twice",
        "data": f"seeded PNG files {TRAINER_IMAGE}x{TRAINER_IMAGE} "
                f"({TRAINER_ROWS}), crops {IMAGE_SIZE}, "
                f"{TRAINER_WORKERS} loader threads",
        "data_write_s": t_data, "run_s": t_run,
        "loader_item_ms_one_thread": loader_ms,
        "model": "ViT-B-32 xtag, bf16 over fp32 masters, seeded random init",
        "profiled_epoch": TRAINER_EPOCHS if profile else None,
        "batch": TRAIN_BATCH, "accum_freq": TRAINER_ACCUM,
        "steps_per_epoch": steps_per_epoch, "epochs": per_epoch,
        "eval_images": eval_images, "eval_img_per_s":
            eval_images / sum(c["s"] for c in evals),
        "classifier_builds": len(builds),
        "checkpoint_save_s": saves,
        "resumed_at_epoch": resumed_epoch, "reload_bit_exact": reload_exact,
        "checkpoints": listing, "missing": missing,
        "not_deleted": stale, "finite": finite,
        "plain_loss_falls": falling,
        "launches": counts,
        "launches_per_plain_step": per_plain_step,
        "launches_per_accum_step": per_accum_step,
        "launches_per_eval_batch": per_eval_batch,
        "launches_per_classifier_build": per_build}
    _emit(result)
    want_plain = _paths()["b32"]["per_step"]
    want_accum = _want(fused_attn_half=48 * TRAINER_ACCUM,
                       fused_mlp_half=48 * TRAINER_ACCUM,
                       fused_attn_half_bwd=24 * TRAINER_ACCUM,
                       normalize_images=1)
    want_eval = _paths()["b32"]["per_batch"]
    want_build = _paths()["b32"]["per_chunk"]
    if not (finite and falling and reload_exact and not missing
            and not stale and resumed_epoch == TRAINER_EPOCHS - 1
            and len(epochs) == TRAINER_EPOCHS + 1
            and per_plain_step == want_plain
            and per_accum_step == want_accum
            and per_eval_batch == want_eval and per_build == want_build):
        raise AssertionError(f"trainer phase failed its checks: {result}")
    return counts


def phase_gap_trainer(card: str, precision: str = "amp",
                      rows=GAP_TRAINER_ROWS, name: str = "gap_trainer"):
    """The GAP tower's main path, part 4: the scar training CLI as a user
    reaches a config of their own, ``--model`` naming a JSON in an
    XTAGCLIP_EXTRA_CONFIGS directory (ViT-B-16's config with the GAP
    vision overrides): one plain epoch with the scar eval and the
    checkpoint policy, at ``--precision precision`` on ``rows``. Returns
    the launches of the call."""
    from xtagclip_tpu_torch.cli import main_other
    from xtagclip_tpu_torch.factory import get_model_config
    from xtagclip_tpu_torch.train import checkpoint, zero_shot
    from xtagclip_tpu_torch.train.logger import close_logging

    path = _paths()["gap"]
    log = []
    targets = ((main_other, "train_one_epoch"), (zero_shot, "run_scar_eval"),
               (zero_shot, "build_zero_shot_classifier"),
               (checkpoint, "save_train_state"))
    env_before = os.environ.get("XTAGCLIP_EXTRA_CONFIGS")
    with tempfile.TemporaryDirectory(prefix="xtag_gap_trainer_") as tmp:
        cfg = get_model_config(path["model"])
        cfg["vision_cfg"].update(GAP_VISION)
        cfg_dir = os.path.join(tmp, "configs")
        os.makedirs(cfg_dir)
        with open(os.path.join(cfg_dir, f"{GAP_CONFIG}.json"), "w") as f:
            json.dump(cfg, f)
        rng = np.random.default_rng(1)
        t0 = time.perf_counter()
        csvs = {split: _write_scar_split(os.path.join(tmp, split), n, rng,
                                         GAP_TRAINER_IMAGE)
                for split, n in rows.items()}
        t_data = time.perf_counter() - t0
        logs = os.path.join(tmp, "logs")
        argv = [
            "--model", GAP_CONFIG, "--use-tagging", "--use-fusion",
            "--train-data", os.path.join(tmp, "scar_train"),
            "--val-data", os.path.join(tmp, "scar_val"),
            "--scar-train-csv", csvs["scar_train"],
            "--scar-val-csv", csvs["scar_val"],
            "--batch-size", str(TRAIN_BATCH), "--workers",
            str(TRAINER_WORKERS), "--precision", precision, "--lr",
            str(TRAIN_LR), "--wd", str(TRAIN_WD), "--warmup",
            str(TRAIN_WARMUP), "--prompt-template-setting", "total",
            "--logs", logs, "--name", "gap", "--log-every-n-steps", "1",
            "--zeroshot-frequency", "1", "--save-best", "--seed", "0",
            "--epochs", "1"]
        os.environ["XTAGCLIP_EXTRA_CONFIGS"] = cfg_dir
        _reset_counts()
        t0 = time.perf_counter()
        try:
            with _probed(targets, log):
                out = main_other.main(argv)
        finally:
            if env_before is None:
                os.environ.pop("XTAGCLIP_EXTRA_CONFIGS", None)
            else:
                os.environ["XTAGCLIP_EXTRA_CONFIGS"] = env_before
            close_logging()
        t_run = time.perf_counter() - t0
        counts = _counts()
        listing = sorted(os.listdir(os.path.join(logs, "gap", "checkpoints")))
        missing = [a for a in ARTIFACTS + (
            "epoch_1", "epoch_latest", "last", "best_train_top1",
            "best_train_loss", "best_val_top1", "best_tag_acc")
            if a not in listing]
        cls_free = "visual.class_embedding" not in \
            out["state"].model.state_dict()

    (rec,) = out["epochs"]
    tm, ev = rec["train"], rec["eval"]
    trains = [c for c in log if c["what"] == "train_one_epoch"]
    evals = [c for c in log if c["what"] == "run_scar_eval"]
    builds = [c for c in log if c["what"] == "build_zero_shot_classifier"]
    steps = rows["scar_train"] // TRAIN_BATCH
    eval_images = sum(c["out"]["n"] for c in evals)
    eval_batches = sum(math.ceil(c["out"]["n"] / TRAIN_BATCH) for c in evals)
    per_step = _per(trains, steps)
    per_eval_batch = _per(evals, eval_batches)
    per_build = _per(builds, len(builds))
    evals_kept = {k: ev[k] for k in sorted(ev) if k.endswith((
        "top1", "top2", "tag_accuracy", "tag_f1", "-n"))}
    values = [tm["loss"], tm["samples_per_second"], tm["p50_step_s"],
              *evals_kept.values()]
    finite = all(math.isfinite(v) for v in values)
    result = {
        "phase": name, "card": card,
        "entry": f"xtagclip_tpu_torch.cli.main_other.main --model "
                 f"{GAP_CONFIG} (XTAGCLIP_EXTRA_CONFIGS) --precision "
                 f"{precision}",
        "model": f"{path['label']} xtag, seeded random init",
        "data": f"seeded PNG files {GAP_TRAINER_IMAGE}x{GAP_TRAINER_IMAGE} "
                f"({rows}), crops {GAP_IMAGE_SIZE}, "
                f"{TRAINER_WORKERS} loader threads",
        "data_write_s": t_data, "run_s": t_run, "batch": TRAIN_BATCH,
        "steps": steps, "samples_per_s": tm["samples_per_second"],
        "p50_step_ms": 1e3 * tm["p50_step_s"], "loss": tm["loss"],
        "eval_s": rec["eval_s"], "checkpoint_s": rec["checkpoint_s"],
        "eval": evals_kept, "eval_images": eval_images,
        "eval_img_per_s": eval_images / sum(c["s"] for c in evals),
        "classifier_builds": len(builds), "checkpoints": listing,
        "missing": missing, "cls_free": cls_free, "finite": finite,
        "launches": counts, "launches_per_plain_step": per_step,
        "launches_per_eval_batch": per_eval_batch,
        "launches_per_classifier_build": per_build}
    _emit(result)
    want = ((path["per_step"], path["per_batch"], path["per_chunk"])
            if precision == "amp" else _fp16_per())
    if not (finite and not missing and cls_free
            and (per_step, per_eval_batch, per_build) == want):
        raise AssertionError(f"GAP trainer phase failed its checks: {result}")
    return counts


FP16_TRAINER_ROWS = {"scar_train": 32, "scar_val": 16}


def _fp16_per() -> tuple:
    """The GAP tower's launches in pure_fp16 per train step, per eval
    batch and per classifier build: #6's float16 kernels in the vision
    blocks and #5 once a batch; nothing else (the text tower's float16
    route is plain)."""
    return (_want(flash_mha_f16=12, flash_mha_bwd_f16=12, normalize_images=1),
            _want(flash_mha_f16=12, normalize_images=1), _want())


PREDICT_IMAGES = 70  # two batches of 32 and a ragged one of 6
SERVED_OPS = {  # custom-op nodes of each exported serve_classify program
    "b32": {"fused_attn_half": 12, "fused_mlp_half": 12,
            "normalize_images": 1},
    "gap": {"flash_mha": 12, "fused_mlp": 12, "normalize_images": 1}}


def _write_pngs(root, n: int, side: int, rng) -> None:
    from PIL import Image

    os.makedirs(root)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
                        ).save(os.path.join(root, f"img_{i:03d}.png"),
                               compress_level=1)


def _decode_ms(root, side: int) -> float:
    """Host ms per image of the CLI's decode and eval crop, one thread."""
    from PIL import Image

    from xtagclip_tpu_torch.data.transforms import (
        PreprocessCfg,
        image_transform_eval,
    )

    transform = image_transform_eval(PreprocessCfg(size=side))
    names = sorted(os.listdir(root))
    t0 = time.perf_counter()
    for n in names:
        np.asarray(transform(Image.open(os.path.join(root, n)).convert("RGB")))
    return 1e3 * (time.perf_counter() - t0) / len(names)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _op_nodes(program) -> dict:
    """{custom op: nodes} of an exported program's graph module."""
    out = {}
    for n in program.graph.nodes:
        target = str(n.target)
        if n.op == "call_function" and target.startswith("xtagclip_tpu_torch."):
            name = target.split(".")[1]
            out[name] = out.get(name, 0) + 1
    return out


def _step_window(fn, batches, n: int = N_SERVE_BATCHES) -> dict:
    """img/s and p50 batch ms of ``fn`` over ``n`` batches cycling
    ``batches`` (uint8 on the device in, results on the device out), each
    ending in a synchronize, after N_WARMUP_BATCHES calls."""
    for i in range(N_WARMUP_BATCHES):
        fn(batches[i % len(batches)])
    torch.cuda.synchronize()
    lat = []
    t_window = time.perf_counter()
    for i in range(n):
        t0 = time.perf_counter()
        fn(batches[i % len(batches)])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    t_window = time.perf_counter() - t_window
    return {"img_per_s": SERVE_BATCH * n / t_window,
            "p50_batch_ms": 1e3 * statistics.median(lat),
            "window_s": t_window}


def _within(out, ref) -> tuple:
    """(ok, max abs err, atol) under atol = max|ref|/128."""
    out, ref = out.float(), ref.float()
    atol = ref.abs().max().item() / 128
    err = (out - ref).abs().max().item()
    return bool(err <= atol and torch.isfinite(out).all().item()), err, atol


def _graph_vs_eager(eager, graphed, batches) -> dict:
    """Each batch through the replayed graph and through an eager call of
    the same step: tag picks equal, features and logits within
    max|ref|/128, and whether every output held bit for bit."""
    ok, bits, errs = True, True, {"feat": 0.0, "logits": 0.0}
    for x in batches:
        got = [t.clone() for t in graphed(x)]  # the graph's static outputs
        want = eager(x)
        torch.cuda.synchronize()
        ok &= torch.equal(got[1], want[1])
        for key, j in (("feat", 0), ("logits", 2)):
            close, err, _ = _within(got[j], want[j])
            ok &= close
            errs[key] = max(errs[key], err)
        bits &= all(torch.equal(g, w) for g, w in zip(got, want))
    return {"ok": bool(ok), "bit_equal": bool(bits),
            "feat_max_abs_err": errs["feat"],
            "logits_max_abs_err": errs["logits"]}


def _graphed_serve(runner, eager, batches, per_batch) -> dict:
    """Warm up and capture ``runner`` on the first batch, counting the
    launches of each; then the replays against ``eager`` and both timed
    over the same window. Raises if the launches at capture are not one
    batch's ``per_batch`` or a replay counts one."""
    x0 = batches[0]
    _reset_counts()
    runner.warm_up(x0)
    warm = _counts()
    _reset_counts()
    runner.capture(x0)
    capture = _counts()
    _reset_counts()
    graphed = _step_window(runner, batches)
    replays = _counts()
    eager_t = _step_window(eager, batches)
    check = _graph_vs_eager(eager, runner, batches)
    zero = _want()
    if warm != per_batch or capture != per_batch or replays != zero:
        raise AssertionError(
            f"CUDA graph launches: warm-up {warm}, capture {capture} (want "
            f"{per_batch} each), replays {replays} (want none)")
    return {"launches_warm_up": warm, "launches_at_capture": capture,
            "launches_in_replays": replays, "graph_vs_eager": check,
            "eager": eager_t, "graphed": graphed,
            "speedup": graphed["img_per_s"] / eager_t["img_per_s"]}


def phase_predict(card: str, model, table, resume_tag: str, tmp: str):
    """Main path, part 5: the predict CLI, ``predict.main``, as a user runs
    it on XTag ViT-B-32 at full width in bf16: the seeded model written as
    an open_clip .pt (convert/export.py), 70 seeded 224x224 PNGs (batches
    of 32, 32 and a ragged 6), then the CLI with --pretrained and
    --fusion-classify --export-serving, from the artifact
    (--serving-artifact), on the zero-shot head (--use-tagging, then
    --fusion-scoring), and with --resume on the trainer phase's last tag.
    Then the serve step (uint8 on the card in) as a CUDA graph against its
    eager calls, both timed over the serve phase's window. Returns the
    CLI calls' launches."""
    from xtagclip_tpu_torch.cli import predict
    from xtagclip_tpu_torch.convert import serving as cs
    from xtagclip_tpu_torch.convert.export import save_open_clip_checkpoint
    from xtagclip_tpu_torch.factory import (
        cast_for_compute,
        create_model,
        load_checkpoint,
    )
    from xtagclip_tpu_torch.serving import CudaGraphRunner, make_serve_classify
    from xtagclip_tpu_torch.train import metadata

    path = _paths()["b32"]
    root = os.path.join(tmp, "predict")
    os.makedirs(root)
    pt = os.path.join(root, "vit_b32_xtag.pt")
    t0 = time.perf_counter()
    save_open_clip_checkpoint(model, pt)
    t_pt = time.perf_counter() - t0
    back = create_model("ViT-B-32", use_tagging=True, use_fusion=True,
                        precision="bf16", init_seed=1)
    load_checkpoint(back, pt)
    cast_for_compute(back, torch.bfloat16)
    theirs = dict(back.named_parameters())
    reload_exact = all(torch.equal(p, theirs[n])
                       for n, p in model.named_parameters())
    del back, theirs
    images = os.path.join(root, "images")
    _write_pngs(images, PREDICT_IMAGES, IMAGE_SIZE, np.random.default_rng(7))
    decode_ms = _decode_ms(images, IMAGE_SIZE)

    art = os.path.join(root, "artifact")
    runs = {
        "live": ["--model", "ViT-B-32", "--pretrained", pt,
                 "--fusion-classify", "--export-serving", art],
        "artifact": ["--serving-artifact", art, "--fusion-classify"],
        "zero_shot": ["--model", "ViT-B-32", "--pretrained", pt,
                      "--use-tagging"],
        "fusion_scoring": ["--model", "ViT-B-32", "--pretrained", pt,
                           "--use-tagging", "--fusion-scoring"],
        "resume": ["--model", "ViT-B-32", "--resume", resume_tag,
                   "--fusion-classify"],
    }
    log, recs, cli = [], {}, {}
    targets = ((cs, "save_serving"), (cs, "load_serving"),
               (CudaGraphRunner, "__call__"))
    _reset_counts()
    with _probed(targets, log):
        for name, flags in runs.items():
            out = os.path.join(root, f"{name}.jsonl")
            n_before = len(log)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                predict.main(["--input", images, "--batch-size",
                              str(SERVE_BATCH), "--output", out, *flags])
            wall = time.perf_counter() - t0
            recs[name] = _jsonl(out)
            calls = [c for c in log[n_before:] if c["what"] == "__call__"]
            cli[name] = {
                "s": wall, "img_per_s": len(recs[name]) / wall,
                "serve_calls": len(calls),
                "first_call_ms": 1e3 * calls[0]["s"],
                "later_calls_ms": [1e3 * c["s"] for c in calls[1:]],
                "launches_first_call": calls[0]["launches"],
                "launches_later_calls": _per(calls[1:], 1),
                "printed": said.getvalue().strip().splitlines()}
    cli_counts = _counts()
    manifest = cs.read_manifest(art)
    loads = [c for c in log if c["what"] == "load_serving"]
    program = loads[0]["out"]["serve_classify"].fn

    names = metadata.SCAR_CLASSNAMES
    live, from_art = recs["live"], recs["artifact"]
    art_ok = len(live) == len(from_art) == PREDICT_IMAGES and all(
        (a["image"], a["class"], a["tags"]) == (b["image"], b["class"],
                                                b["tags"])
        and all(abs(a["probs"][c] - p) < 0.05 for c, p in b["probs"].items())
        for a, b in zip(from_art, live))
    art_max_prob_err = max(abs(a["probs"][c] - p) for a, b in zip(
        from_art, live) for c, p in b["probs"].items())
    recs_ok = all(
        len(r) == PREDICT_IMAGES and all(
            x["class"] in names and len(x["tags"]) == 6
            and all(math.isfinite(p) for p in x["probs"].values())
            for x in r) for r in recs.values())
    twice = _scaled(path["per_batch"], 2)  # an eager warm-up + the capture
    launches_ok = all(
        c["serve_calls"] == math.ceil(PREDICT_IMAGES / SERVE_BATCH)
        and c["launches_first_call"] == twice
        and not any(c["launches_later_calls"].values()) for c in cli.values())
    nodes = _op_nodes(program)

    # the serve step as a CUDA graph against its eager calls
    batches = [b.to("cuda") for b in _serve_batches(IMAGE_SIZE)]
    eager = make_serve_classify(model, table)
    graph = _graphed_serve(CudaGraphRunner(eager), eager, batches,
                           path["per_batch"])
    result = {
        "phase": "predict", "card": card,
        "entry": "xtagclip_tpu_torch.cli.predict.main, five calls",
        "model": "ViT-B-32 xtag bf16, seeded random init via an open_clip .pt",
        "pt_write_s": t_pt, "pt_bytes": os.path.getsize(pt),
        "pt_reload_bit_exact": reload_exact,
        "images": PREDICT_IMAGES, "host_decode_ms_per_image": decode_ms,
        "cli": cli,
        "artifact_entries": {k: {f: v[f] for f in (
            "bytes", "export_s", "save_s", "in_avals", "out_avals")}
            for k, v in manifest["entries"].items()},
        "artifact_load_s": loads[0]["s"],
        "artifact_vs_live": {"ok": art_ok, "max_prob_err": art_max_prob_err},
        "records_ok": recs_ok, "launches_ok": launches_ok,
        "serve_classify_op_nodes": nodes, "graph": graph,
        "launches": cli_counts}
    _emit(result)
    if not (reload_exact and art_ok and recs_ok and launches_ok
            and nodes == SERVED_OPS["b32"] and graph["graph_vs_eager"]["ok"]):
        raise AssertionError(f"predict phase failed its checks: {result}")
    return cli_counts


def phase_gap_predict(card: str, model, table, tmp: str):
    """The GAP tower's serving artifact: serve_classify exported
    (convert/serving.py), loaded and replayed as a CUDA graph against the
    live eager step, with the predict phase's bars; its program holds 12
    flash attention, 12 fused MLP and one normalize custom-op nodes.
    Returns the launches of the artifact's warm-up and capture (its
    export and load launch none, its replays count none)."""
    from xtagclip_tpu_torch.convert import serving as cs
    from xtagclip_tpu_torch.serving import make_serve_classify
    from xtagclip_tpu_torch.train import metadata

    path = _paths()["gap"]
    art = os.path.join(tmp, "gap_artifact")
    batches = [b.to("cuda") for b in _serve_batches(GAP_IMAGE_SIZE)]
    eager = make_serve_classify(model, table)
    _reset_counts()
    t0 = time.perf_counter()
    manifest = cs.save_serving(model, art, model_name=GAP_CONFIG, entries=(),
                               serve_classify_table=table,
                               classnames=metadata.SCAR_CLASSNAMES)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner = cs.load_serving(art)["serve_classify"]
    t_load = time.perf_counter() - t0
    graph = _graphed_serve(runner, eager, batches, path["per_batch"])
    counts = {k: v + graph["launches_at_capture"][k]  # replays count none
              for k, v in graph["launches_warm_up"].items()}
    nodes = _op_nodes(runner.fn)
    entry = manifest["entries"]["serve_classify"]
    result = {"phase": "gap_predict", "card": card,
              "model": f"{path['label']} xtag bf16, seeded random init",
              "export_s": entry["export_s"], "save_s": entry["save_s"],
              "bytes": entry["bytes"], "save_serving_s": t_save,
              "load_s": t_load, "in_avals": entry["in_avals"],
              "out_avals": entry["out_avals"],
              "serve_classify_op_nodes": nodes, "graph": graph}
    _emit(result)
    if not (nodes == SERVED_OPS["gap"] and graph["graph_vs_eager"]["ok"]):
        raise AssertionError(f"gap_predict phase failed its checks: {result}")
    return counts


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# the CLIPA configs the no-argument run drives at half depth (vision 16 of
# 32 blocks, text 12 of 24; widths as published), to keep its ~600 s aim
# with the pretrained phase: a config of each name in a temporary
# XTAGCLIP_EXTRA_CONFIGS directory (_depth_cut_configs)
CLIPA_DEPTH_CUT = ("ViT-H-14-CL8-SyntaxMask-GAP", "ViT-H-14-CL32-GAP",
                   "ViT-H-14-CL32-GAP-BigVision")


def _tower_layers(name: str) -> tuple:
    """(vision blocks, text blocks) of config ``name`` as the factory
    finds it (a depth-cut config included)."""
    from xtagclip_tpu_torch.factory import get_model_config

    cfg = get_model_config(name)
    return cfg["vision_cfg"]["layers"], cfg["text_cfg"]["layers"]


def _clipa_per_step(name: str) -> dict:
    """Launches of each wrapper per CLIPA train step under
    --grad-checkpointing: every forward kernel of the vision blocks (flash
    attention at dh 80, the fused MLP) and of the text blocks (the two
    halves) runs twice, once in the forward and once in the recompute of
    its block's backward; the backward kernels once; one normalize."""
    v, t = _tower_layers(name)
    return dict(flash_mha=2 * v, flash_mha_bwd=v, fused_mlp=2 * v,
                fused_attn_half=2 * t, fused_mlp_half=2 * t,
                fused_attn_half_bwd=t, normalize_images=1)


def _clipa_per_eval_batch(name: str) -> dict:
    """Per eval batch: each forward kernel once."""
    v, t = _tower_layers(name)
    return dict(flash_mha=v, fused_mlp=v, fused_attn_half=t,
                fused_mlp_half=t, normalize_images=1)


def _depth_cut_configs(tmp: str) -> str:
    """A directory of CLIPA_DEPTH_CUT's configs at half depth, for
    XTAGCLIP_EXTRA_CONFIGS."""
    from xtagclip_tpu_torch.factory import get_model_config

    d = os.path.join(tmp, "depth_cut")
    os.makedirs(d)
    for name in CLIPA_DEPTH_CUT:
        cfg = get_model_config(name)
        for tower in ("vision_cfg", "text_cfg"):
            cfg[tower]["layers"] //= 2
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump(cfg, f)
    return d
CLIPA_WORDS = ("red", "small", "dog", "cat", "tree", "house", "blue", "car",
               "on", "grass", "near", "water", "old", "photo", "of", "a")
CLIPA_LONG_CAPTION = ("a photo of a very large fluffy orange cat sitting on "
                      "an old wooden table")


def _write_wds_shards(root: str, n_shards: int, per_shard: int,
                      rng) -> str:
    """``n_shards`` tar shards of ``per_shard`` (JPEG, caption) samples in
    the webdataset layout (key.jpg, key.txt): smooth seeded images of
    LAION-like sizes around 300 px, five- to eight-word captions. Returns
    the brace pattern of their paths."""
    import tarfile

    from PIL import Image

    os.makedirs(root)
    sizes = ((256, 320), (320, 256), (288, 288), (240, 360))
    for s in range(n_shards):
        with tarfile.open(os.path.join(root, f"shard-{s:04d}.tar"),
                          "w") as tf:
            for i in range(per_shard):
                h, w = sizes[(s + i) % len(sizes)]
                small = rng.integers(0, 256, (h // 16, w // 16, 3),
                                     dtype=np.uint8)
                buf = io.BytesIO()
                Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
                    buf, "JPEG", quality=90)
                caption = " ".join(rng.choice(CLIPA_WORDS,
                                              rng.integers(5, 9)))
                for name, data in ((f"{s:04d}{i:05d}.jpg", buf.getvalue()),
                                   (f"{s:04d}{i:05d}.txt",
                                    caption.encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return os.path.join(root, "shard-{0000..%04d}.tar" % (n_shards - 1))


def _clipa_args(stage: int, logs: str, batch: int = CLIPA_BATCH,
                shards: str = None) -> list:
    """cli.main's flags of scripts/h14_84_8_pretrain.sh (stage 1) and
    scripts/h14_224_32_finetune.sh (stage 2), with the one-process cuts:
    no --fsdp, the per-device batch ``batch`` instead of 4096, one epoch
    of seeded JPEG tar shards (``shards``, --dataset-type webdataset as the
    scripts pass; synthetic data where none are given) of 2 steps (stage
    1) and 2 + 3 steps (stage 2), and stage 2's preprocessing flags of the
    JAX package's CLIPA test (tests/test_clipa_path.py). Stage 1 adds
    --native-decode (the native library's decode and random resized crop,
    as "$@" can add it to the script); stage 2 decodes with PIL, as the
    script does."""
    data = (["--train-data", shards, "--dataset-type", "webdataset"]
            + (["--native-decode"] if stage == 1 else [])) if shards else \
        ["--dataset-type", "synthetic"]
    common = [*data, "--batch-size", str(batch),
              "--precision", "amp_bf16", "--beta1", "0.9", "--beta2", "0.95",
              "--wd", "0.2", "--eps", "1e-8", "--epochs", "1",
              "--grad-checkpointing", "--local-loss", "--gather-with-grad",
              "--workers", "4", "--log-every-n-steps", "1", "--logs", logs,
              "--name", f"stage{stage}", "--seed", "0"]
    if stage == 1:
        return ["--model", "ViT-H-14-CL8-SyntaxMask-GAP", *common,
                "--train-num-samples", str(2 * batch),
                "--lr", "2.048e-3", "--warmup", "3200",
                "--force-image-size", "84"]
    return ["--model", "ViT-H-14-CL32-GAP", *common,
            "--train-num-samples",
            str((CLIPA_WARMUP + CLIPA_STEPS) * batch),
            "--lr", "2.048e-4", "--warmup", "800",
            "--force-image-size", "224",
            "--pretrained", os.path.join(logs, "stage1", "checkpoints",
                                         "epoch_1"),
            "--image-resize-mode", "squash", "--image-interpolation",
            "bilinear", "--image-mean", *map(str, IMAGENET_MEAN),
            "--image-std", *map(str, IMAGENET_STD)]


def _clipa_tokens() -> dict:
    """Stage 1's syntax-mask tokenizer: nltk's tagger where its data is on
    disk, else the front-truncation fallback, whose ids are checked."""
    from xtagclip_tpu_torch.factory import get_tokenizer
    from xtagclip_tpu_torch.tokenize import masking

    tok = get_tokenizer("ViT-H-14-CL8-SyntaxMask-GAP")
    texts = ["Dummy caption", CLIPA_LONG_CAPTION]
    got = tok(texts)
    fallback = masking.nltk_tagger() is None
    want = []
    for text in texts:  # words[:context - 2], then BPE with SOT and EOT
        ids = ([tok.sot_token_id] + tok.encode(" ".join(text.split()[:6]))
               + [tok.eot_token_id])
        if len(ids) > 8:
            ids = ids[:8]
            ids[-1] = tok.eot_token_id
        want.append(ids + [0] * (8 - len(ids)))
    return {"path": "fallback" if fallback else "nltk",
            "ids": got.tolist(),
            "ok": (not fallback) or got.tolist() == want}


def _write_val_csv(root: str, n: int, rng) -> str:
    """``n`` seeded 224x224 PNGs and a tab-separated CSV of their paths
    and five-word captions."""
    _write_pngs(root, n, IMAGE_SIZE, rng)
    rows = ["filepath\ttitle"]
    for i in range(n):
        rows.append(f"{os.path.join(root, f'img_{i:03d}.png')}\t"
                    + " ".join(rng.choice(CLIPA_WORDS, 5)))
    path = os.path.join(root, "val.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def _ckpt_bytes(tag_dir: str) -> int:
    return sum(os.path.getsize(os.path.join(tag_dir, f))
               for f in os.listdir(tag_dir))


def _profile_clipa_step(card: str, state, n_steps: int = 3) -> None:
    """torch.profiler window of ``n_steps`` stage-2 train steps of
    CLIPA_BATCH (the CLI's step: contrastive loss, AdamW) on seeded
    batches already on the card."""
    from xtagclip_tpu_torch.ops import preprocess
    from xtagclip_tpu_torch.train.loop import make_train_step

    rng = np.random.default_rng(300)
    images = torch.from_numpy(rng.integers(
        0, 256, (CLIPA_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3),
        dtype=np.uint8)).to("cuda")
    texts = torch.from_numpy(rng.integers(
        1, 49000, (CLIPA_BATCH, 32))).to("cuda")
    step = make_train_step({"use_tagging_loss": False})
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run():
        nonlocal state
        for _ in range(n_steps):
            batch = {"images": preprocess.normalize_images(
                images, IMAGENET_MEAN, IMAGENET_STD, dtype=torch.bfloat16),
                "texts": texts}
            state, _ = step(state, batch, gen)

    _profile_window(f"ViT-H-14-CL32-GAP stage 2: train {n_steps} steps of "
                    f"{CLIPA_BATCH} (--grad-checkpointing)", run, card,
                    top=25)


def phase_clipa(card: str, tmp: str, profile: bool = False) -> dict:
    """The CLIPA ViT-H/14 recipe through cli.main at full width (the
    depth its configs have: CLIPA_DEPTH_CUT halves it in the no-argument
    run),
    both stages reading seeded JPEG tar shards (--dataset-type
    webdataset): stage 1 (CL8 syntax mask, 84 px, L = 37, --native-decode)
    for 2 steps, then stage 2 (CL32, 224 px, L = 257, the PIL decode) from
    stage 1's checkpoint (--pretrained: the vision table resized 6x6 ->
    16x16, the text table 8 -> 32) for 2 + 3 steps, then ``evaluate`` on a
    val CSV of seeded PNGs. Launch counts per step and per eval batch are
    asserted; each step's data wait and the decode route are printed; the
    shards and checkpoints are deleted."""
    import gc

    from xtagclip_tpu_torch.cli import main as clipa_main
    from xtagclip_tpu_torch.data.datasets import CsvDataset
    from xtagclip_tpu_torch.data.registry import _loader
    from xtagclip_tpu_torch.data.transforms import (
        PreprocessCfg,
        image_transform_eval,
    )
    from xtagclip_tpu_torch.factory import get_tokenizer
    from xtagclip_tpu_torch.train.evaluate import evaluate
    from xtagclip_tpu_torch.train.logger import close_logging
    from xtagclip_tpu_torch.train.params import parse_args

    logs = os.path.join(tmp, "clipa")
    tokens = _clipa_tokens()
    counts, stages = {}, {}
    t0 = time.perf_counter()
    shards = _write_wds_shards(
        os.path.join(tmp, "clipa_shards"), CLIPA_SHARDS,
        (CLIPA_WARMUP + CLIPA_STEPS) * CLIPA_BATCH // CLIPA_SHARDS,
        np.random.default_rng(21))
    shards_s = time.perf_counter() - t0
    try:
        for stage in (1, 2):
            gc.collect()
            torch.cuda.empty_cache()
            resident = torch.cuda.memory_allocated()  # earlier phases'
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            out = clipa_main.main(_clipa_args(stage, logs, shards=shards))
            wall = time.perf_counter() - t0
            counts[f"clipa_stage{stage}"] = _counts()
            rec = out["epochs"][0]
            tm = rec["train"]
            steps = len(tm["interval_step_s"])
            timed = tm["interval_step_s"][CLIPA_WARMUP:] if stage == 2 \
                else tm["interval_step_s"]
            tag = os.path.join(logs, f"stage{stage}", "checkpoints",
                               "epoch_1")
            model = out["state"].model
            stages[stage] = {
                "model": model.model_name, "wall_s": wall, "steps": steps,
                "step_s": tm["interval_step_s"],
                "samples_per_s": CLIPA_BATCH * len(timed) / sum(timed),
                "p50_step_ms": 1e3 * statistics.median(timed),
                "loss": tm["loss"], "logit_scale": tm["logit_scale"],
                "grad_norm": tm["grad_norm"],
                "peak_mem_gb": (torch.cuda.max_memory_allocated()
                                - resident) / 1e9,
                "resident_before_gb": resident / 1e9,
                "checkpoint_bytes": _ckpt_bytes(tag),
                "checkpoint_save_s": rec["checkpoint_s"],
                "launches": counts[f"clipa_stage{stage}"],
                "launches_ok": counts[f"clipa_stage{stage}"]
                == _want(**_scaled(_clipa_per_step(model.model_name),
                                   steps)),
                "layers": _tower_layers(model.model_name),
                "data_wait_ms": [1e3 * t for t in tm["data_step_s"]],
                "decode": tm["decode"], "decoded": tm["decoded"],
                "decoded_all": sum(tm["decoded"].values())
                >= steps * CLIPA_BATCH,
                "vision_tokens": model.visual.positional_embedding.shape[0],
                "text_context": model.text.positional_embedding.shape[0],
                "grad_checkpointing":
                    model.visual.transformer.grad_checkpointing,
                "finite": all(math.isfinite(tm[k])
                              for k in ("loss", "grad_norm"))}
            if stage == 1:
                del out, model
                close_logging()
                continue
            if profile:
                _profile_clipa_step(card, out["state"])
            # evaluate on the val CSV (stage 2's preprocessing)
            val_root = os.path.join(tmp, "clipa_val")
            csv = _write_val_csv(val_root, CLIPA_VAL_ROWS,
                                 np.random.default_rng(9))
            args = parse_args(["--val-data", csv, "--dataset-type", "csv",
                               "--batch-size", str(CLIPA_EVAL_BATCH),
                               "--workers", "4", "--model",
                               "ViT-H-14-CL32-GAP"], include_xtag=False)
            args.checkpoint_path = None
            tok = get_tokenizer("ViT-H-14-CL32-GAP")
            pp = PreprocessCfg(**model.preprocess_cfg)
            data = {"val": _loader(CsvDataset(
                csv, image_transform_eval(pp), img_key="filepath",
                caption_key="title", tokenizer=tok), args, is_train=False)}
            evaluate(model, data, 1, args, tok)  # warm-up
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            metrics = evaluate(model, data, 1, args, tok)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            counts["clipa_eval"] = _counts()
            n_batches = -(-CLIPA_VAL_ROWS // CLIPA_EVAL_BATCH)
            stages["eval"] = {
                "rows": CLIPA_VAL_ROWS, "seconds": eval_s,
                "img_per_s": CLIPA_VAL_ROWS / eval_s, "metrics": metrics,
                "launches": counts["clipa_eval"],
                "launches_ok": counts["clipa_eval"]
                == _want(**_scaled(_clipa_per_eval_batch(
                    "ViT-H-14-CL32-GAP"), n_batches)),
                "preprocess": {k: model.preprocess_cfg[k] for k in
                               ("mean", "std", "interpolation",
                                "resize_mode")},
                "finite": all(math.isfinite(v) for v in metrics.values()
                              if isinstance(v, float))}
            del out, model, data
            close_logging()
    finally:
        shutil.rmtree(logs, ignore_errors=True)
        shutil.rmtree(os.path.dirname(shards), ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    s1, s2, ev = stages[1], stages[2], stages["eval"]
    ok = (tokens["ok"] and s1["launches_ok"] and s2["launches_ok"]
          and s1["decoded_all"] and s2["decoded_all"]
          and s2["decode"] == "PIL"
          and ev["launches_ok"] and s1["finite"] and s2["finite"]
          and ev["finite"] and s1["steps"] == 2
          and s2["steps"] == CLIPA_WARMUP + CLIPA_STEPS
          and (s1["vision_tokens"], s1["text_context"]) == (37, 8)
          and (s2["vision_tokens"], s2["text_context"]) == (257, 32)
          and tuple(ev["preprocess"]["mean"]) == IMAGENET_MEAN
          and ev["metrics"]["num_samples"] == CLIPA_VAL_ROWS)
    result = {"phase": "clipa", "card": card,
              "recipe": "CLIPA ViT-H/14 GAP (BASELINE config 5) via cli.main",
              "weights": "seeded random init", "batch": CLIPA_BATCH,
              "cuts": "no --fsdp (one process); batch 256 not 4096; 1 epoch "
                      "of seeded JPEG tar shards (--dataset-type webdataset)",
              "shards": {"count": CLIPA_SHARDS, "write_s": shards_s},
              "tokenizer": tokens, "stage1": s1, "stage2": s2, "eval": ev,
              "ok": ok}
    _emit(result)
    if not ok:
        raise AssertionError(f"clipa phase failed its checks: {result}")
    return counts


# the 336 px BigVision evaluation: the model the script names and its
# image folder (ImageNet's layout: one directory of JPEGs per class); the
# launches of each wrapper per zero-shot classifier chunk are the text
# tower's blocks (10 classes x 80 templates), per eval batch the vision
# tower's blocks at L = 577 and one normalize
BV_MODEL = "ViT-H-14-CL32-GAP-BigVision"
EVAL_CLASSES, EVAL_PER_CLASS = 8, 24
# what JAX's big_vision converter (and so the port's) leaves of a CLIPA-v2
# archive: the keys it does not read, and the towers' parameters that keep
# their init (ROADMAP Queue 3); the XTag tag head's, which no CLIPA archive
# holds, keep theirs too
BV_UNREAD = ["img/embedding/bias", "img/head/bias", "img/head/kernel"]
BV_KEPT_TOWERS = ["visual.class_embedding", "visual.proj",
                  "visual.ln_pre.scale", "visual.ln_pre.bias",
                  "text.text_projection"]


class _Records(logging.Handler):
    """Keeps the log records that carry ``attr``."""

    def __init__(self, attr: str):
        super().__init__(logging.WARNING)
        self.attr, self.records = attr, []

    def emit(self, record):
        if hasattr(record, self.attr):
            self.records.append(record)


def _write_big_vision_npz(path: str, cfg: dict, rng) -> int:
    """A seeded big_vision archive in the CLIPA-v2 ViT-H/14 layout and the
    geometry ``cfg`` implies at 336 px: 'img/' (the patch embedding's
    kernel and bias, a 24 x 24 position table, 32 encoder blocks of width
    1280 with 16 heads of 80 and MLP 5120, the encoder norm, the image
    head to 1024) and 'txt/' (a 32000 x 1024 embedding, a 32-row position
    table, 24 blocks of width 1024 with 16 heads of 64, the norm, the text
    head), and 't'. Written one array at a time (the zip layout of
    np.savez); returns its bytes."""
    import zipfile

    v, t = cfg["vision_cfg"], cfg["text_cfg"]
    embed = cfg["embed_dim"]

    def put(zf, key, shape, std, mean=0.0):
        arr = rng.standard_normal(shape, dtype=np.float32)
        arr *= std
        arr += mean
        with zf.open(key + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, arr, allow_pickle=False)

    def blocks(zf, prefix, n, d, heads):
        dh = d // heads
        for i in range(n):
            b = f"{prefix}/encoderblock_{i}"
            for ln in ("LayerNorm_0", "LayerNorm_1"):
                put(zf, f"{b}/{ln}/scale", (d,), 0.02, 1.0)
                put(zf, f"{b}/{ln}/bias", (d,), 0.02)
            att = f"{b}/MultiHeadDotProductAttention_0"
            for name in ("query", "key", "value"):
                put(zf, f"{att}/{name}/kernel", (d, heads, dh), d**-0.5)
                put(zf, f"{att}/{name}/bias", (heads, dh), 0.02)
            put(zf, f"{att}/out/kernel", (heads, dh, d), d**-0.5)
            put(zf, f"{att}/out/bias", (d,), 0.02)
            mlp = f"{b}/MlpBlock_0"
            put(zf, f"{mlp}/Dense_0/kernel", (d, 4 * d), d**-0.5)
            put(zf, f"{mlp}/Dense_0/bias", (4 * d,), 0.02)
            put(zf, f"{mlp}/Dense_1/kernel", (4 * d, d), (4 * d)**-0.5)
            put(zf, f"{mlp}/Dense_1/bias", (d,), 0.02)

    p, w = v["patch_size"], v["width"]
    grid = EVAL_IMAGE_SIZE // p
    tw = t["width"]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        put(zf, "img/embedding/kernel", (p, p, 3, w), (p * p * 3)**-0.5)
        put(zf, "img/embedding/bias", (w,), 0.02)
        put(zf, "img/pos_embedding", (1, grid * grid, w), 0.02)
        blocks(zf, "img/Transformer", v["layers"], w, w // v["head_width"])
        put(zf, "img/Transformer/encoder_norm/scale", (w,), 0.02, 1.0)
        put(zf, "img/Transformer/encoder_norm/bias", (w,), 0.02)
        put(zf, "img/head/kernel", (w, embed), w**-0.5)
        put(zf, "img/head/bias", (embed,), 0.02)
        put(zf, "txt/Embed_0/embedding", (t["vocab_size"], tw), 0.02)
        put(zf, "txt/pos_embedding", (1, t["context_length"], tw), 0.02)
        blocks(zf, "txt/Encoder_0", t["layers"], tw, t["heads"])
        put(zf, "txt/Encoder_0/encoder_norm/scale", (tw,), 0.02, 1.0)
        put(zf, "txt/Encoder_0/encoder_norm/bias", (tw,), 0.02)
        put(zf, "txt/head/kernel", (tw, embed), tw**-0.5)
        put(zf, "txt/head/bias", (embed,), 0.02)
        put(zf, "t", (1,), 0.0, math.log(10.0))
    return os.path.getsize(path)


def _bn_state(put, prefix: str, ch: int, rng) -> None:
    """A torch BatchNorm's five entries, seeded: weight near 1, small
    bias and running mean, running var in [0.5, 1.5]."""
    put(prefix + "weight", 1.0 + 0.1 * rng.standard_normal(ch))
    put(prefix + "bias", 0.1 * rng.standard_normal(ch))
    put(prefix + "running_mean", 0.1 * rng.standard_normal(ch))
    put(prefix + "running_var", rng.uniform(0.5, 1.5, ch))
    put(prefix + "num_batches_tracked", np.asarray(100, np.int64))


def _putter(sd: dict):
    def put(key, value):
        value = np.asarray(value)
        sd[key] = (value if value.dtype == np.int64
                   else value.astype(np.float32))
    return put


def torchvision_resnet_state_dict(rng, layers=(3, 4, 6, 3),
                                  num_classes: int = 1000) -> dict:
    """A seeded torchvision ResNet state dict (resnet50 at the default
    ``layers``): its keys, shapes and layouts, He-normal convs, BN entries
    as ``_bn_state``, and the ``fc`` classifier."""
    sd = {}
    put = _putter(sd)

    def conv(key, out_ch, in_ch, k):
        put(key, rng.standard_normal((out_ch, in_ch, k, k))
            * (2.0 / (in_ch * k * k)) ** 0.5)

    conv("conv1.weight", 64, 3, 7)
    _bn_state(put, "bn1.", 64, rng)
    in_ch = 64
    for li, blocks in enumerate(layers):
        planes = 64 * 2**li
        for bi in range(blocks):
            b = f"layer{li + 1}.{bi}."
            conv(b + "conv1.weight", planes, in_ch, 1)
            _bn_state(put, b + "bn1.", planes, rng)
            conv(b + "conv2.weight", planes, planes, 3)
            _bn_state(put, b + "bn2.", planes, rng)
            conv(b + "conv3.weight", planes * 4, planes, 1)
            _bn_state(put, b + "bn3.", planes * 4, rng)
            if bi == 0:
                conv(b + "downsample.0.weight", planes * 4, in_ch, 1)
                _bn_state(put, b + "downsample.1.", planes * 4, rng)
            in_ch = planes * 4
    put("fc.weight", rng.standard_normal((num_classes, in_ch)) * in_ch**-0.5)
    put("fc.bias", 0.01 * rng.standard_normal(num_classes))
    return sd


def modified_resnet_state_dict(rng, layers, width: int, embed_dim: int,
                               image_size: int) -> dict:
    """A seeded open_clip ModifiedResNet ``visual.*`` state dict: the
    3-conv stem with bn1..bn3, ``layer{l}.{b}`` bottlenecks (downsample
    ``0``: conv, ``1``: BN, after the unnamed average pool) and
    ``attnpool``."""
    sd = {}
    put = _putter(sd)

    def conv(key, out_ch, in_ch, k):
        put("visual." + key, rng.standard_normal((out_ch, in_ch, k, k))
            * (2.0 / (in_ch * k * k)) ** 0.5)

    conv("conv1.weight", width // 2, 3, 3)
    conv("conv2.weight", width // 2, width // 2, 3)
    conv("conv3.weight", width, width // 2, 3)
    for i, ch in ((1, width // 2), (2, width // 2), (3, width)):
        _bn_state(put, f"visual.bn{i}.", ch, rng)
    in_ch = width
    for li, blocks in enumerate(layers):
        planes = width * 2**li
        for bi in range(blocks):
            b = f"layer{li + 1}.{bi}."
            conv(b + "conv1.weight", planes, in_ch, 1)
            conv(b + "conv2.weight", planes, planes, 3)
            conv(b + "conv3.weight", planes * 4, planes, 1)
            for j, ch in ((1, planes), (2, planes), (3, planes * 4)):
                _bn_state(put, f"visual.{b}bn{j}.", ch, rng)
            if bi == 0:
                conv(b + "downsample.0.weight", planes * 4, in_ch, 1)
                _bn_state(put, f"visual.{b}downsample.1.", planes * 4, rng)
            in_ch = planes * 4
    grid = image_size // 32
    put("visual.attnpool.positional_embedding",
        rng.standard_normal((grid * grid + 1, in_ch)) * in_ch**-0.5)
    for name, out in (("q", in_ch), ("k", in_ch), ("v", in_ch),
                      ("c", embed_dim)):
        put(f"visual.attnpool.{name}_proj.weight",
            rng.standard_normal((out, in_ch)) * in_ch**-0.5)
        put(f"visual.attnpool.{name}_proj.bias",
            0.02 * rng.standard_normal(out))
    return sd


BIOMEDCLIP_GEOMETRY = dict(  # BiomedCLIP-PubMedBERT_256-vit_base_patch16_224
    width=768, layers=12, patch=16, image_size=224, embed_dim=512,
    vocab=30522, hidden=768, text_layers=12, intermediate=3072,
    max_positions=512)


def biomedclip_state_dict(rng, width: int, layers: int, patch: int,
                          image_size: int, embed_dim: int, vocab: int,
                          hidden: int, text_layers: int, intermediate: int,
                          max_positions: int) -> dict:
    """A seeded open_clip state dict in BiomedCLIP's layout: a timm
    ``vit_*`` trunk under ``visual.trunk.*`` (cls token, [1, L, D]
    position table, biased patch-embed conv, fused qkv, final norm), the
    linear head ``visual.head.proj``, an HF BERT under
    ``text.transformer.*`` (its pooler included, as the hub checkpoint
    holds it), the mlp projection ``text.proj.{0,2}`` and ``logit_scale``.
    Weights are normal with std 0.02, LayerNorm weights near 1."""
    sd = {}
    put = _putter(sd)

    def w(*shape):
        return 0.02 * rng.standard_normal(shape)

    def ln(key, d):
        put(key + ".weight", 1.0 + 0.02 * rng.standard_normal(d))
        put(key + ".bias", 0.02 * rng.standard_normal(d))

    def linear(key, out_f, in_f, bias=True):
        put(key + ".weight", w(out_f, in_f))
        if bias:
            put(key + ".bias", w(out_f))

    t = "visual.trunk."
    n = (image_size // patch) ** 2 + 1
    put(t + "cls_token", w(1, 1, width))
    put(t + "pos_embed", w(1, n, width))
    put(t + "patch_embed.proj.weight", w(width, 3, patch, patch))
    put(t + "patch_embed.proj.bias", w(width))
    for i in range(layers):
        b = f"{t}blocks.{i}."
        ln(b + "norm1", width)
        linear(b + "attn.qkv", 3 * width, width)
        linear(b + "attn.proj", width, width)
        ln(b + "norm2", width)
        linear(b + "mlp.fc1", 4 * width, width)
        linear(b + "mlp.fc2", width, 4 * width)
    ln(t + "norm", width)
    linear("visual.head.proj", embed_dim, width, bias=False)
    e = "text.transformer.embeddings."
    put(e + "word_embeddings.weight", w(vocab, hidden))
    put(e + "position_embeddings.weight", w(max_positions, hidden))
    put(e + "token_type_embeddings.weight", w(2, hidden))
    ln(e + "LayerNorm", hidden)
    for i in range(text_layers):
        b = f"text.transformer.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            linear(b + "attention.self." + name, hidden, hidden)
        linear(b + "attention.output.dense", hidden, hidden)
        ln(b + "attention.output.LayerNorm", hidden)
        linear(b + "intermediate.dense", intermediate, hidden)
        linear(b + "output.dense", hidden, intermediate)
        ln(b + "output.LayerNorm", hidden)
    linear("text.transformer.pooler.dense", hidden, hidden)
    mid = (hidden + embed_dim) // 2
    linear("text.proj.0", mid, hidden, bias=False)
    linear("text.proj.2", embed_dim, mid, bias=False)
    put("logit_scale", np.asarray(math.log(1 / 0.07)))
    return sd


def save_state_dict(sd: dict, path: str) -> str:
    """``sd`` as a torch checkpoint ``{"state_dict": ...}`` at ``path``."""
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, path)
    return path


BERT_SPECIALS = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
                 + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])


def write_wordpiece_vocab(directory: str, words, size: int = 30522) -> str:
    """A BERT WordPiece vocabulary in ``directory``: vocab.txt with
    BERT's special ids ([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK]
    103), the printable ASCII characters, the letters' ## pieces and the
    lowercase ``words``, filled to ``size`` ids with unused entries, and
    an uncased tokenizer_config.json. Returns the directory."""
    letters = [chr(c) for c in range(97, 123)]
    tokens = list(dict.fromkeys(
        BERT_SPECIALS
        + [chr(c) for c in range(33, 127) if not chr(c).isupper()]
        + ["##" + c for c in letters] + sorted(set(words) - set(letters))))
    tokens += [f"[unused{i}]" for i in range(99, 99 + size - len(tokens))]
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.txt"), "w") as f:
        f.write("\n".join(tokens) + "\n")
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "model_max_length": 512,
                   "tokenizer_class": "BertTokenizer"}, f)
    return directory


def scar_prompt_words() -> list:
    """The lowercase words of the scar pseudo-prompts: the templates, the
    class names and the tag list."""
    import re

    from xtagclip_tpu_torch.tokenize.prompts import PROMPT_TEMPLATES
    from xtagclip_tpu_torch.train import metadata
    from xtagclip_tpu_torch.utils.assets import read_tag_list

    text = " ".join([*PROMPT_TEMPLATES.values(), *metadata.SCAR_CLASSNAMES,
                     *read_tag_list()])
    return sorted(set(re.findall(r"[a-z]+", text.lower())))


def write_hub_snapshot(hub: str, repo_id: str,
                       rev: str = "6f3e0b2c4d5a69788796a5b4c3d2e1f001122334"
                       ) -> str:
    """The snapshot directory of hub repo ``repo_id`` in the hub cache
    ``hub``, laid out as the hub's cache is (``models--<org>--<name>/``
    with ``refs/main`` naming ``snapshots/<rev>/``), made empty for the
    caller's files."""
    repo = os.path.join(hub, "models--" + repo_id.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", rev)
    os.makedirs(snap, exist_ok=True)
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(rev)
    return snap


def clip_layout_state_dict(model, dtype=torch.float32) -> dict:
    """``model``'s CLIP towers as a public open_clip CLIP checkpoint holds
    them (the OpenAI layout too): the text tower's keys at the top level,
    no tag head or TQN, tensors in ``dtype`` (copies, never views of a
    CPU model's parameters)."""
    from xtagclip_tpu_torch.convert.export import to_openclip_state_dict

    return {(k[len("text."):] if k.startswith("text.") else k):
            torch.tensor(v).to(dtype)
            for k, v in to_openclip_state_dict(model).items()
            if not k.startswith(("tag_", "fusion_model."))}


def _write_bert_hub_cache(hub: str) -> str:
    """bert-base-uncased as a hub cache holds it offline
    (models--bert-base-uncased/snapshots/<revision>/ with refs/main): a
    WordPiece vocab.txt with BERT's special ids ([PAD] 0, [UNK] 100, [CLS]
    101, [SEP] 102, [MASK] 103), the words of the ImageNet templates and
    class names, the letters and their ## pieces; tokenizer_config.json
    with do_lower_case and the model's config.json, as the hub's snapshot
    holds them. Returns the snapshot directory."""
    import re

    from xtagclip_tpu_torch.train import metadata

    words = set()
    for text in (*metadata.OPENAI_IMAGENET_TEMPLATES,
                 *metadata.IMAGENET_CLASSNAMES):
        words.update(re.findall(r"[a-z]+", text.lower()))
    letters = [chr(c) for c in range(97, 123)]
    tokens = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
              + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
              + [chr(c) for c in range(33, 127) if not chr(c).isalpha()
                 or chr(c).islower()]
              + ["##" + c for c in letters]
              + sorted(words - set(letters)))
    rev = "86b5e0934494bd15c9632b12f734a8a67f723594"
    repo = os.path.join(hub, "models--bert-base-uncased")
    snap = os.path.join(repo, "snapshots", rev)
    os.makedirs(snap)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(rev)
    with open(os.path.join(snap, "vocab.txt"), "w") as f:
        f.write("\n".join(tokens) + "\n")
    with open(os.path.join(snap, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "model_max_length": 512}, f)
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump({"architectures": ["BertForMaskedLM"], "model_type": "bert",
                   "transformers_version": "4.6.0.dev0",
                   "vocab_size": len(tokens)}, f)
    return snap


def _write_image_folder(root: str, classes: int, per_class: int,
                        rng) -> int:
    """ImageNet's val layout: ``classes`` synset directories of
    ``per_class`` seeded JPEGs of ImageNet's common sizes."""
    from PIL import Image

    sizes = ((375, 500), (500, 375), (333, 500), (500, 500))
    for c in range(classes):
        d = os.path.join(root, f"n{1440764 + c:08d}")
        os.makedirs(d)
        for i in range(per_class):
            h, w = sizes[(c + i) % len(sizes)]
            small = rng.integers(0, 256, (h // 16, w // 16, 3),
                                 dtype=np.uint8)
            Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
                os.path.join(d, f"ILSVRC2012_val_{c:03d}{i:05d}.JPEG"),
                quality=90)
    return classes * per_class


@contextlib.contextmanager
def _timing(module, name: str, seconds: list, first_args: list = None):
    """Time every call of ``module.<name>`` into ``seconds`` (the card
    synchronized before and after), keeping its first argument in
    ``first_args``; the attribute is put back after."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if first_args is not None:
            first_args.append(args[0])
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_clipa_eval(card: str, tmp: str) -> dict:
    """scripts/clipav2_vit_h14_i84_224_336_cl32_gap_datacomp1b.sh through
    cli.main at full width (the depth its config has: CLIPA_DEPTH_CUT
    halves it in the no-argument run): ViT-H-14-CL32-GAP-BigVision from a
    seeded big_vision .npz (--pretrained), --force-image-size 336 (L =
    577, dh 80), squash, bilinear, ImageNet mean/std, the BERT WordPiece
    tokenizer found as bert-base-uncased in a temporary HF_HUB_CACHE, and
    --imagenet-val a folder of seeded JPEGs: the 1000-class zero-shot
    classifier (80 templates) and the eval. It prints the load, classifier
    and eval seconds and the eval img/s, asserts the launches per
    classifier chunk and per eval batch, and holds one eval batch's image
    features and one classifier chunk's text features (800 prompts, the
    chunk the text tower runs on) with the kernels on against the same
    model with them off (cosine >= 0.999, the clipa_path bar). It prints
    the archive keys the loader left unread and the parameters it kept at
    their init, and holds them to BV_UNREAD and BV_KEPT_TOWERS. The .npz
    is deleted after."""
    import gc

    from xtagclip_tpu_torch import factory
    from xtagclip_tpu_torch.cli import main as clipa_main
    from xtagclip_tpu_torch.data.datasets import ImageFolderDataset
    from xtagclip_tpu_torch.data.transforms import (
        PreprocessCfg,
        image_transform_eval,
    )
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops import preprocess
    from xtagclip_tpu_torch.train import metadata, zero_shot
    from xtagclip_tpu_torch.train.logger import close_logging

    root = os.path.join(tmp, "clipa_eval")
    os.makedirs(root)
    rng = np.random.default_rng(336)
    try:
        t0 = time.perf_counter()
        npz = os.path.join(root, "vit_h14_i84_224_336_cl32_gap_"
                                 "datacomp1b.npz")
        npz_bytes = _write_big_vision_npz(npz, factory.get_model_config(
            BV_MODEL), rng)
        write_s = time.perf_counter() - t0
        hub = os.path.join(root, "hub")
        snapshot = _write_bert_hub_cache(hub)
        val = os.path.join(root, "imagenet_val")
        n_images = _write_image_folder(val, EVAL_CLASSES, EVAL_PER_CLASS,
                                       rng)
        argv = ["--model", BV_MODEL, "--pretrained", npz,
                "--force-image-size", str(EVAL_IMAGE_SIZE),
                "--image-resize-mode", "squash",
                "--image-interpolation", "bilinear",
                "--image-mean", *map(str, IMAGENET_MEAN),
                "--image-std", *map(str, IMAGENET_STD), "--seed", "0",
                "--imagenet-val", val,
                # "$@": the eval batch, loader threads and log directory
                "--batch-size", str(CLIPA_EVAL_BATCH), "--workers", "4",
                "--logs", os.path.join(root, "logs"), "--name", "eval"]
        load_s, classifier_s, eval_s, models = [], [], [], []
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loaded = _Records("big_vision_unread")
        logging.getLogger().addHandler(loaded)
        with _env(HF_HUB_CACHE=hub), \
                _timing(factory, "load_checkpoint", load_s), \
                _timing(zero_shot, "build_zero_shot_classifier",
                        classifier_s), \
                _timing(zero_shot, "run_classification_eval", eval_s,
                        models):
            _reset_counts()
            t0 = time.perf_counter()
            metrics = clipa_main.main(argv)
            wall = time.perf_counter() - t0
            counts = _counts()
            tokenizer = factory.get_tokenizer(BV_MODEL)
        close_logging()
        logging.getLogger().removeHandler(loaded)
        unread = [r.big_vision_unread for r in loaded.records]
        kept = [r.big_vision_kept for r in loaded.records]
        kept_towers = [n for n in (kept or [[]])[0]
                       if n.startswith(("visual.", "text."))]
        model = models[0]
        prompts = (len(metadata.IMAGENET_CLASSNAMES)
                   * len(metadata.OPENAI_IMAGENET_TEMPLATES))
        chunks = -(-len(metadata.IMAGENET_CLASSNAMES) // 10)
        n_batches = -(-n_images // CLIPA_EVAL_BATCH)
        v_layers, t_layers = _tower_layers(BV_MODEL)
        want = _want(fused_attn_half=t_layers * chunks,
                     fused_mlp_half=t_layers * chunks,
                     flash_mha=v_layers * n_batches,
                     fused_mlp=v_layers * n_batches,
                     normalize_images=n_batches)

        # one eval batch's image features, kernels on vs off
        pp = PreprocessCfg(**model.preprocess_cfg)
        ds = ImageFolderDataset(val, transform=image_transform_eval(pp))
        images = torch.from_numpy(np.stack(
            [ds[i][0] for i in range(CLIPA_EVAL_BATCH)])).to("cuda")
        norm = dict(mean=pp.mean, std=pp.std, dtype=model.dtype)
        model.eval()
        with torch.no_grad():
            f_k, _ = model.encode_image(
                preprocess.normalize_images(images, **norm), normalize=True)
            set_use_kernels(model, False)
            try:
                f_p, _ = model.encode_image(
                    preprocess.normalize_images_reference(images, **norm),
                    normalize=True)
            finally:
                set_use_kernels(model, True)
        feat_cos = _cosine(f_k, f_p).min().item()
        # one classifier chunk's text features (its first 10 classes x 80
        # templates, as build_zero_shot_classifier chunks them), kernels on
        # vs off
        texts = [metadata.format_template(t, c)
                 for c in metadata.IMAGENET_CLASSNAMES[:10]
                 for t in metadata.OPENAI_IMAGENET_TEMPLATES]
        ids = torch.from_numpy(np.asarray(tokenizer(texts), np.int64)).to(
            "cuda")
        with torch.no_grad():
            t_k = model.encode_text(ids, normalize=True)[0]
            set_use_kernels(model, False)
            try:
                t_p = model.encode_text(ids, normalize=True)[0]
            finally:
                set_use_kernels(model, True)
        text_cos = _cosine(t_k, t_p).min().item()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tokens = model.visual.positional_embedding.shape[0]
        del model, models, f_k, f_p, t_k, t_p, images
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    ok = (counts == want and feat_cos >= 0.999 and text_cos >= 0.999
          and len(texts) == EVAL_CHUNK_PROMPTS and tokens == EVAL_L
          and unread == [BV_UNREAD] and kept_towers == BV_KEPT_TOWERS
          and all(n.startswith("tag_") for n in kept[0]
                  if n not in kept_towers)
          and metrics.get("imagenet-val-n") == n_images
          and all(math.isfinite(v) for v in metrics.values()
                  if isinstance(v, float)))
    result = {
        "phase": "clipa_eval", "card": card,
        "script": "scripts/clipav2_vit_h14_i84_224_336_cl32_gap_"
                  "datacomp1b.sh via cli.main",
        "weights": "seeded big_vision .npz (CLIPA-v2 ViT-H/14 layout)",
        "npz_bytes": npz_bytes, "npz_write_s": write_s,
        "tokenizer": {"name": "bert-base-uncased", "snapshot": snapshot},
        "vision_tokens": tokens, "images": n_images,
        "batch": CLIPA_EVAL_BATCH, "wall_s": wall,
        "load_s": sum(load_s),
        "classifier": {"prompts": prompts, "seconds": sum(classifier_s),
                       "prompts_per_s": prompts / sum(classifier_s)},
        "eval": {"seconds": sum(eval_s),
                 "img_per_s": n_images / sum(eval_s)},
        "metrics": metrics, "peak_mem_gb": peak_gb,
        "launches": counts, "launches_want": want,
        "eval_feature_cos_min": feat_cos,
        "classifier_chunk_text_cos_min": text_cos,
        "big_vision_unread": unread, "big_vision_kept": kept, "ok": ok}
    _emit(result)
    if not ok:
        raise AssertionError(f"clipa_eval phase failed its checks: {result}")
    return counts


# per-device batches tried by --clipa-batch-probe, in order, until one
# does not fit
CLIPA_PROBE_BATCHES = (512, 768, 1024, 1280, 1536)


def phase_clipa_batch_probe(card: str, tmp: str) -> dict:
    """The largest per-device batch of CLIPA stage 2 (ViT-H-14-CL32-GAP,
    224 px, --grad-checkpointing, AdamW) that fits on the card: cli.main
    with stage 2's flags from a seeded init (no --pretrained; the memory
    is the same) for 2 steps at each of CLIPA_PROBE_BATCHES, saving
    nothing, until one runs out of memory. Records each batch's peak
    torch.cuda.max_memory_allocated and step seconds."""
    import gc

    from xtagclip_tpu_torch.cli import main as clipa_main
    from xtagclip_tpu_torch.train.logger import close_logging

    logs = os.path.join(tmp, "clipa_probe")
    total = torch.cuda.mem_get_info()[1]
    rows, fits = [], None
    for batch in CLIPA_PROBE_BATCHES:
        args = _clipa_args(2, logs, batch)
        args[args.index("--train-num-samples") + 1] = str(2 * batch)
        cut = args.index("--pretrained")
        args = args[:cut] + args[cut + 2:] + ["--save-frequency", "0"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row = {"batch": batch}
        try:
            out = clipa_main.main(args)
            tm = out["epochs"][0]["train"]
            row.update(fits=True, step_s=tm["interval_step_s"],
                       loss=tm["loss"],
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            del out
            fits = batch
        except torch.cuda.OutOfMemoryError as e:
            row.update(fits=False, error=str(e).split("\n")[0][:300],
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        finally:
            close_logging()
            shutil.rmtree(logs, ignore_errors=True)
        rows.append(row)
        if not row["fits"]:
            break
    gc.collect()
    torch.cuda.empty_cache()
    result = {"phase": "clipa_batch_probe", "card": card,
              "model": "ViT-H-14-CL32-GAP stage 2, 224 px, "
                       "--grad-checkpointing, amp_bf16, AdamW",
              "card_memory_gb": total / 1e9,
              "allocator": os.environ.get("PYTORCH_CUDA_ALLOC_CONF",
                                          "default"),
              "batches": rows,
              "largest_batch_that_fits": fits}
    _emit(result)
    return result


def _fwd_bwd_memory(model, batch) -> dict:
    """GB a forward leaves held for its backward (``held_after_forward``)
    and the peak of forward + backward (``peak``), both over what was
    resident before; the model's gradients are cleared after."""
    from xtagclip_tpu_torch.losses import clip_loss

    model.zero_grad(set_to_none=True)
    gc_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = model(batch["images"], text=batch["texts"], deterministic=True)
    loss = clip_loss(out["image_features"], out["text_features"],
                     out["logit_scale"])
    held = torch.cuda.memory_allocated() - gc_base
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - gc_base
    del out, loss
    model.zero_grad(set_to_none=True)
    return {"held_after_forward": held / 1e9, "peak": peak / 1e9}


BIOMEDCLIP = "BiomedCLIP-PubMedBERT_256-vit_base_patch16_224"
BIOMEDCLIP_TOKENIZER = "microsoft/BiomedNLP-BiomedBERT-base-uncased-abstract"
BASELINE_BATCH = 4  # scar_Biomedclip_pretrain.sh's and the baselines' batch
BASELINE_ROWS = {"scar_train": 64, "scar_val": 32}
BASELINE_EPOCHS = 2


def _write_biomedclip_hub_cache(hub: str) -> str:
    """BiomedCLIP's tokenizer as a hub cache holds it offline
    (models--microsoft--BiomedNLP-BiomedBERT-base-uncased-abstract/
    snapshots/<revision>/ with refs/main): a 30522-id uncased WordPiece
    vocab.txt over the scar prompt words (write_wordpiece_vocab), its
    tokenizer_config.json and the model's config.json. Returns the
    snapshot directory."""
    rev = "d673b8835373c6fa116d6d8006b33d48734e305d"
    repo = os.path.join(hub, "models--" + BIOMEDCLIP_TOKENIZER.replace(
        "/", "--"))
    snap = write_wordpiece_vocab(os.path.join(repo, "snapshots", rev),
                                 scar_prompt_words())
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(rev)
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump({"architectures": ["BertForMaskedLM"], "model_type": "bert",
                   "vocab_size": 30522}, f)
    return snap


def _baseline_data(root: str, rng) -> dict:
    """The baselines' scar splits (BASELINE_ROWS seeded PNG rows each)."""
    return {split: (os.path.join(root, split),
                    _write_scar_split(os.path.join(root, split), n, rng))
            for split, n in BASELINE_ROWS.items()}


@contextlib.contextmanager
def _peak_memory(out: dict):
    """The block's peak device memory, and its peak over what was resident
    when it began (earlier phases' models stay allocated)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out["peak_memory_gb"] = peak / 1e9
        out["peak_over_resident_gb"] = (peak - resident) / 1e9


def phase_biomedclip_scar(card: str, tmp: str, profile: bool = False) -> dict:
    """BASELINE config 3 as scar_Biomedclip_pretrain.sh runs it:
    ``main_other.main`` with its flags (--model BIOMEDCLIP --lock-image
    --lock-text --use-tagging --precision amp --lr 5e-6 --wd 0.1 --warmup
    50 --prompt-template-setting sentence_1) at full width and depth, batch
    4, one epoch over 64 seeded scar rows (val 32), --pretrained
    ``tmp``/biomedclip.pt, which it writes (a seeded open_clip-layout
    BiomedCLIP state dict: timm ``visual.trunk.*``, HF
    ``text.transformer.*``, ``text.proj.{0,2}``; the baselines phase reads
    and deletes it), and the PubMedBERT tokenizer found in a temporary
    HF_HUB_CACHE. The
    towers run plain PyTorch in bf16 (JAX's XLA path); kernel #5
    normalizes every batch. Asserts: the model built is BiomedCLIP (a timm
    tower and an HF BERT, the checkpoint's values loaded), every locked
    parameter bit-equal after the epoch, one #5 launch per train and eval
    batch and nothing else, finite losses and eval. Prints the prompt
    table's build seconds, samples/s, p50 step ms, the p50 wait for a
    batch, eval img/s and peak memory. With ``profile``, the epoch (loader
    included) runs inside a torch.profiler window. Returns the launches."""
    from xtagclip_tpu_torch.cli import main_other
    from xtagclip_tpu_torch.models.hf_text import HFTextEncoder
    from xtagclip_tpu_torch.models.timm_vit import TimmModel
    from xtagclip_tpu_torch.train import zero_shot
    from xtagclip_tpu_torch.train.logger import close_logging

    root = os.path.join(tmp, "biomedclip_scar")
    os.makedirs(root)
    t0 = time.perf_counter()
    ckpt = save_state_dict(biomedclip_state_dict(
        np.random.default_rng(2), **BIOMEDCLIP_GEOMETRY),
        os.path.join(tmp, "biomedclip.pt"))
    write_s = time.perf_counter() - t0
    data = _baseline_data(root, np.random.default_rng(3))
    hub = os.path.join(root, "hub")
    _write_biomedclip_hub_cache(hub)
    logs = os.path.join(root, "logs")
    (train, train_csv), (val, val_csv) = data["scar_train"], data["scar_val"]
    argv = ["--batch-size", str(BASELINE_BATCH), "--workers", "4",
            "--train-data", train, "--val-data", val,
            "--scar-train-csv", train_csv, "--scar-val-csv", val_csv,
            "--precision", "amp", "--warmup", "50", "--lr", "5e-6",
            "--wd", "0.1", "--epochs", "1", "--lock-image", "--lock-text",
            "--model", BIOMEDCLIP, "--pretrained", ckpt,
            "--prompt-template-setting", "sentence_1", "--use-tagging",
            "--logs", logs, "--name", "biomedclip", "--seed", "0",
            "--log-every-n-steps", "1", "--zeroshot-frequency", "1"]
    created, table_s, log, mem = {}, [], [], {}
    create = main_other.create_model_and_transforms
    train_one_epoch = main_other.train_one_epoch

    def profiled_epoch(*a, **k):
        out = []
        steps = BASELINE_ROWS["scar_train"] // BASELINE_BATCH
        _profile_window(
            f"biomedclip_scar epoch: {steps} steps of {BASELINE_BATCH} "
            "with the loader",
            lambda: out.append(train_one_epoch(*a, **k)), card, top=15)
        return out[0]

    def create_and_keep(*a, **k):
        out = create(*a, **k)
        created["model"] = out[0]
        created["towers"] = {n: p.detach().clone()
                             for n, p in out[0].named_parameters()
                             if n.startswith(("visual.", "text."))}
        return out

    main_other.create_model_and_transforms = create_and_keep
    if profile:
        main_other.train_one_epoch = profiled_epoch
    _reset_counts()
    t0 = time.perf_counter()
    try:
        with _env(HF_HUB_CACHE=hub), _timing(main_other, "PromptTable",
                                             table_s), \
                _probed(((main_other, "train_one_epoch"),
                         (zero_shot, "run_scar_eval")), log), \
                _peak_memory(mem):
            out = main_other.main(argv)
    finally:
        main_other.create_model_and_transforms = create
        main_other.train_one_epoch = train_one_epoch
        close_logging()
    run_s = time.perf_counter() - t0
    counts = _counts()
    model = created["model"]
    n_params = sum(p.numel() for p in model.parameters())
    sd_q = torch.load(ckpt, map_location="cpu", weights_only=True)[
        "state_dict"]["visual.trunk.blocks.0.attn.qkv.weight"]
    loaded = torch.equal(model.visual.trunk.blocks[0].qkv.kernel.detach()
                         .cpu().T, sd_q)
    is_biomedclip = (isinstance(model.visual, TimmModel)
                     and isinstance(model.text, HFTextEncoder)
                     and n_params == 209_326_594 and loaded)
    changed = [n for n, p in model.named_parameters()
               if n in created["towers"]
               and not torch.equal(p, created["towers"][n])]
    (rec,) = out["epochs"]
    tm, ev = rec["train"], rec["eval"]
    steps = BASELINE_ROWS["scar_train"] // BASELINE_BATCH
    trains = [c for c in log if c["what"] == "train_one_epoch"]
    evals = [c for c in log if c["what"] == "run_scar_eval"]
    eval_images = sum(c["out"]["n"] for c in evals)
    eval_batches = sum(math.ceil(c["out"]["n"] / BASELINE_BATCH)
                       for c in evals)
    per_step = _per(trains, steps)
    per_eval_batch = _per(evals, eval_batches)
    evals_kept = {k: ev[k] for k in sorted(ev) if k.endswith((
        "top1", "top2", "tag_accuracy", "tag_f1", "-n"))}
    finite = all(math.isfinite(v) for v in (
        tm["loss"], tm["contrastive_loss"], tm["tagging_loss"],
        *evals_kept.values()))
    result = {
        "phase": "biomedclip_scar", "card": card,
        "entry": "xtagclip_tpu_torch.cli.main_other.main with "
                 "scar_Biomedclip_pretrain.sh's flags",
        "model": f"{BIOMEDCLIP}: {n_params} parameters, bf16 over fp32 "
                 "masters, from a seeded open_clip-layout .pt",
        "is_biomedclip": is_biomedclip,
        "data": f"seeded PNG files ({BASELINE_ROWS}), crops 224",
        "checkpoint_write_s": write_s, "checkpoint_bytes":
            os.path.getsize(ckpt), "run_s": run_s,
        "prompt_table_s": table_s,
        "batch": BASELINE_BATCH, "steps": steps,
        "samples_per_s": tm["samples_per_second"],
        "p50_step_ms": 1e3 * tm["p50_step_s"],
        "p50_data_wait_ms": 1e3 * statistics.median(tm["data_step_s"]),
        "loss": tm["loss"], "contrastive_loss": tm["contrastive_loss"],
        "tagging_loss": tm["tagging_loss"], "eval": evals_kept,
        "eval_images": eval_images,
        "eval_img_per_s": eval_images / sum(c["s"] for c in evals),
        **mem, "locked_changed": changed[:5], "finite": finite,
        "launches": counts, "launches_per_step": per_step,
        "launches_per_eval_batch": per_eval_batch}
    _emit(result)
    want = _want(normalize_images=1)
    if not (is_biomedclip and finite and not changed
            and per_step == want and per_eval_batch == want):
        raise AssertionError(f"biomedclip_scar phase failed its checks: "
                             f"{result}")
    return counts


def _baseline_runs(data: dict, ckpt: str, pth: str, out_dir: str):
    """(label, CLI module, argv) of the baselines phase's four runs."""
    from xtagclip_tpu_torch.cli.baselines import (
        biomedclip_baseline,
        clip_baseline,
        resnet50_baseline,
    )

    (train, train_csv), (val, val_csv) = data["scar_train"], data["scar_val"]

    def argv(tag):
        return ["--train-root", train, "--val-root", val,
                "--train-csv", train_csv, "--val-csv", val_csv,
                "--batch-size", str(BASELINE_BATCH),
                "--epochs", str(BASELINE_EPOCHS),
                "--ckpt", os.path.join(out_dir, f"{tag}.pkl"),
                "--output", os.path.join(out_dir, f"{tag}.png")]

    return (
        ("resnet50", resnet50_baseline,
         argv("resnet50") + ["--pretrained", pth]),
        ("clip_vit_b32", clip_baseline, argv("clip_vit_b32") + [
            "--model", "ViT-B-32", "--lock-image"]),
        ("biomedclip_lock_text", biomedclip_baseline,
         argv("biomedclip_lock_text") + [
             "--pretrained", ckpt, "--lock-image", "--lock-text-encoder"]),
        ("biomedclip", biomedclip_baseline,
         argv("biomedclip") + ["--pretrained", ckpt]),
    )


def _classifier_on(label: str, device: str, tree: dict):
    """The run's classifier on ``device`` holding its saved best tree."""
    from xtagclip_tpu_torch.cli.baselines import clip_baseline, common
    from xtagclip_tpu_torch.cli.baselines.resnet50_baseline import (
        ScarClassifier,
    )

    if label == "resnet50":
        with torch.device(device):
            model = ScarClassifier()
    else:
        name = "ViT-B-32" if label.startswith("clip") else BIOMEDCLIP
        model, _ = clip_baseline.build_classifier(
            name, None, 3, label != "biomedclip", device)
    return common.load_into(model, tree).eval()


def phase_baselines(card: str, tmp: str, ckpt: str) -> dict:
    """BASELINE config 1 and config 3's standalone script: each baseline
    CLI's ``main()`` at full width on the card, BASELINE_EPOCHS epochs of
    batch 4 on seeded scar splits (64 train, 32 val rows): resnet50_baseline
    from a seeded torchvision-layout ResNet-50 .pth (--pretrained),
    clip_baseline on ViT-B-32 (--lock-image), and biomedclip_baseline from
    the seeded BiomedCLIP .pt, with --lock-image --lock-text-encoder and
    with neither. All run in fp32; kernel #5 normalizes every batch to
    fp32. For each: the checkpoint and metrics (and the plot where
    matplotlib is installed), the model built (the fallback ladder's
    warning absent, a BiomedCLIP checkpoint holding the timm trunk), one #5
    launch per train and eval batch, and the best epoch's eval logits on
    the card held to the same weights' on the CPU on the first two val
    batches: within 1e-3 of their largest magnitude, with TF32 off in
    cuBLAS and cuDNN (main()'s setting for this script). Prints epoch
    seconds, samples/s and peak memory. The BiomedCLIP .pt is deleted
    after. Returns the launches of the four runs."""
    from xtagclip_tpu_torch.cli.baselines import common
    from xtagclip_tpu_torch.data.loader import DataLoader
    from xtagclip_tpu_torch.train.logger import close_logging
    from xtagclip_tpu_torch.data.transforms import (
        PreprocessCfg,
        image_transform_eval,
    )
    from xtagclip_tpu_torch.utils.constants import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )

    root = os.path.join(tmp, "baselines")
    os.makedirs(root)
    data = _baseline_data(root, np.random.default_rng(4))
    pth = os.path.join(root, "resnet50.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                torchvision_resnet_state_dict(np.random.default_rng(5)).items()},
               pth)
    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        plots = False
    rows, total = [], {}
    steps = BASELINE_ROWS["scar_train"] // BASELINE_BATCH
    val_batches = math.ceil(BASELINE_ROWS["scar_val"] / BASELINE_BATCH)
    try:
        for label, cli, argv in _baseline_runs(data, ckpt, pth, root):
            histories, mem = [], {}
            run = cli.train_supervised

            def keep(*a, _run=run, **k):
                model, history = _run(*a, **k)
                histories.append(history)
                return model, history

            cli.train_supervised = keep
            records = []
            handler = logging.Handler(logging.WARNING)
            handler.emit = records.append
            logging.getLogger().addHandler(handler)
            _reset_counts()
            t0 = time.perf_counter()
            try:
                with _peak_memory(mem):
                    metrics = cli.main(argv + ["--device", "cuda"])
            finally:
                cli.train_supervised = run
                logging.getLogger().removeHandler(handler)
                close_logging()
            run_s = time.perf_counter() - t0
            counts = _counts()
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            (history,) = histories
            tree = common.load_pytree(os.path.join(root, f"{label}.pkl"))
            fell_back = [r.getMessage() for r in records
                         if "falling back" in r.getMessage()]
            built = (any(n.startswith("visual.trunk.") for n in tree["params"])
                     if label.startswith("biomedclip") else True)
            mean, std = ((IMAGENET_MEAN, IMAGENET_STD)
                         if label == "resnet50" else (None, None))
            pp = PreprocessCfg(size=224, mean=mean, std=std)
            loader = DataLoader(common.ScarClassificationDataset(
                data["scar_val"][0], data["scar_val"][1],
                image_transform_eval(pp), False), BASELINE_BATCH,
                num_workers=2)
            batches = [b for _, b in zip(range(2), loader)]
            logits = {}
            for device in ("cuda", "cpu"):
                model = _classifier_on(label, device, tree)
                logits[device], _ = common.eval_logits(
                    model, batches, device, pp.mean, pp.std)
                del model
            ref = np.concatenate(logits["cpu"])
            err = float(np.abs(np.concatenate(logits["cuda"]) - ref).max())
            bar = 1e-3 * max(1.0, float(np.abs(ref).max()))
            # each epoch's steps and validation, then the final evaluate
            epochs = len(history["train_loss"])
            launches = steps * epochs + val_batches * (epochs + 1)
            row = {
                "run": label, "argv": " ".join(argv[16:]),
                "run_s": run_s, "epoch_s": history["epoch_s"],
                "samples_per_s": [steps * BASELINE_BATCH / s
                                  for s in history["epoch_s"]],
                **mem, "train_loss": history["train_loss"],
                "val_loss": history["val_loss"],
                "accuracy": metrics["accuracy"],
                "macro_f1": metrics["macro_f1"],
                "checkpoint": os.path.isfile(
                    os.path.join(root, f"{label}.pkl")),
                "plot": os.path.isfile(os.path.join(root, f"{label}.png")),
                "fallback": fell_back, "model_built": built,
                "logits_max_abs_err_vs_cpu": err, "logits_bar": bar,
                "normalize_launches": counts["normalize_images"],
                "normalize_launches_want": launches}
            rows.append(row)
            ok = (row["checkpoint"] and (row["plot"] or not plots)
                  and not fell_back and built and err <= bar
                  and counts == _want(normalize_images=launches)
                  and all(math.isfinite(v) for v in (
                      *history["train_loss"], *history["val_loss"]))
                  and {"macro_precision", "macro_recall", "weighted_f1",
                       "per_class"} <= set(metrics))
            if not ok:
                _emit({"phase": "baselines", "card": card, "runs": rows})
                raise AssertionError(f"baselines phase failed its checks: "
                                     f"{row}")
    finally:
        os.remove(ckpt)
    _emit({"phase": "baselines", "card": card,
           "tf32": {"cublas": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "batch": BASELINE_BATCH, "epochs": BASELINE_EPOCHS,
           "data": f"seeded PNG files ({BASELINE_ROWS}), crops 224",
           "plots": plots, "runs": rows})
    return total


# launches of each wrapper in coca_ViT-L-14's paths. Per train step (no
# checkpointing): the 24 ViT-L/14 blocks (flash attention forward and
# backward at dh 64, L = 257; the fused MLP), the 12 text blocks' MLP
# halves (their attention core is plain under the per-sample pad mask),
# the 12 decoder self-attention blocks (both halves and the attention
# half's backward), the 12 cross-attention blocks' MLP halves; one
# normalize. Per image encode (once per generate call and per eval batch):
# the vision blocks and one normalize. Per decoder step of generation (the
# text tower and the decoder over the whole [B, 30] buffer): 12 attention
# halves and 36 MLP halves. Per eval batch the text tower adds 12 MLP
# halves.
COCA_PER_STEP = dict(flash_mha=24, flash_mha_bwd=24, fused_mlp=24,
                     fused_mlp_half=36, fused_attn_half=12,
                     fused_attn_half_bwd=12, normalize_images=1)
COCA_PER_ENCODE = dict(flash_mha=24, fused_mlp=24, normalize_images=1)
COCA_PER_DECODE = dict(fused_attn_half=12, fused_mlp_half=36)
COCA_PER_EVAL_BATCH = dict(COCA_PER_ENCODE, fused_mlp_half=12)


def _sum_counts(*parts) -> dict:
    """``_want`` of the summed {wrapper: launches} of ``parts``."""
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + v
    return _want(**out)


def _coca_images(n: int, seed: int):
    """``n`` seeded uint8 224x224 images, on the card."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(
        0, 256, (n, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)).to("cuda")


def _caption(tok, ids) -> str:
    """The text of a generated row: the ids after SOT up to EOT."""
    ids = [int(i) for i in ids[1:]]
    if tok.eot_token_id in ids:
        ids = ids[:ids.index(tok.eot_token_id)]
    return tok.decode([i for i in ids if i != 0]).strip()


def phase_coca(card: str, profile: bool = False) -> dict:
    """coca_ViT-L-14 in bf16 from a seeded init: ``generate`` on 8 seeded
    images by each method at JAX's defaults (seq_len 30), one warm-up and
    COCA_GEN_RUNS timed calls each (captions/s, p50 ms per batch, the
    launches per call against COCA_PER_ENCODE + COCA_PER_DECODE per decoder
    step, decoded captions); then one decoder step's logits (generate's
    step at the last position of the top-k buffer, on the plain encode's
    image embeddings) with the kernels on against the plain versions from
    the same weights: per-row cosine >= 0.999 and max abs diff <= 5e-2,
    or within twice the plain step's own move when its image embeddings
    move one bf16 step up or down (the noise floor of 36 bf16 blocks over
    8 x 49408 logits; phase_train_path judges gradients so), the plain
    side launching no kernel; and the image
    encode's features and embeddings at cosine >= 0.999 (the serve
    path's bar). The logits of the kernels' step on its own encode are
    printed beside them."""
    from xtagclip_tpu_torch.factory import (
        cast_for_compute,
        create_model,
        get_tokenizer,
    )
    from xtagclip_tpu_torch.models.coca import SOT_ID, generate
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops import preprocess

    t0 = time.perf_counter()
    model = create_model(COCA_MODEL, precision="bf16", init_seed=0)
    cast_for_compute(model, torch.bfloat16)
    model.eval()
    build_s = time.perf_counter() - t0
    tok = get_tokenizer(COCA_MODEL)
    u8 = _coca_images(COCA_GEN_BATCH, 31)
    counts, methods, captions, outputs = {}, {}, {}, {}
    for name, kw in COCA_METHODS.items():
        def run():
            images = preprocess.normalize_images(u8, dtype=torch.bfloat16)
            return generate(model, images, seq_len=COCA_SEQ_LEN, **kw)

        run()  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        times = []
        for _ in range(COCA_GEN_RUNS):
            t1 = time.perf_counter()
            tokens = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        c = counts[f"coca_{name}"] = _counts()
        steps = c["fused_attn_half"] // COCA_PER_DECODE["fused_attn_half"]
        want = _sum_counts(_scaled(COCA_PER_ENCODE, COCA_GEN_RUNS),
                           _scaled(COCA_PER_DECODE, steps))
        p50 = statistics.median(times)
        outputs[name] = tokens
        captions[name] = [_caption(tok, t) for t in tokens[:2]]
        methods[name] = {
            "seconds": times, "p50_ms_per_batch": 1e3 * p50,
            "captions_per_s": COCA_GEN_BATCH / p50,
            "decoder_steps_per_call": steps / COCA_GEN_RUNS,
            "tokens_shape": list(tokens.shape),
            "launches": c, "launches_ok": c == want and steps >= 1,
            "ok": (tokens.shape[0] == COCA_GEN_BATCH
                   and 2 <= tokens.shape[1] <= COCA_SEQ_LEN
                   and bool((tokens[:, 0] == SOT_ID).all())
                   and bool(((tokens >= 0) & (tokens < 49408)).all()))}
    if profile:
        def profiled():
            generate(model, preprocess.normalize_images(
                u8, dtype=torch.bfloat16), seq_len=COCA_SEQ_LEN)

        _profile_window(f"{COCA_MODEL}: generate top_k, batch "
                        f"{COCA_GEN_BATCH}, seq_len {COCA_SEQ_LEN}",
                        profiled, card, top=25)
    # one decoder step (generate's step: the text tower and the decoder
    # over the buffer, given the image embeddings), kernels on vs plain,
    # on the last top-k buffer and the same image embeddings; the image
    # encode held apart, as the serve path's features are
    plain = copy.deepcopy(model)
    set_use_kernels(plain, False)
    buf = np.zeros((COCA_GEN_BATCH, COCA_SEQ_LEN), np.int32)
    buf[:, :outputs["top_k"].shape[1]] = outputs["top_k"]
    text = torch.from_numpy(buf).long().to("cuda")
    latent = torch.zeros((1,), device="cuda")
    with torch.inference_mode():
        def step_logits(net, embs):
            return net(None, text, image_latent=latent, image_embs=embs,
                       output_labels=False,
                       logits_row=COCA_SEQ_LEN - 2)["logits"]

        _reset_counts()
        p_lat, p_embs = plain.encode_image(
            preprocess.normalize_images_reference(u8, dtype=torch.bfloat16))
        logits = {"plain": step_logits(plain, p_embs)}
        torch.cuda.synchronize()
        counts_plain = _counts()
        logits["kernels"] = step_logits(model, p_embs)
        # the plain step's own move under a one-ULP change of its input
        noise = max((step_logits(plain, _bf16_ulp_shift(p_embs, n))
                     - logits["plain"]).abs().max().item() for n in (1, -1))
        k_lat, k_embs = model.encode_image(
            preprocess.normalize_images(u8, dtype=torch.bfloat16))
        own = step_logits(model, k_embs)
    err = (logits["kernels"] - logits["plain"]).abs().max().item()
    cos = _cosine(logits["kernels"], logits["plain"]).min().item()
    enc_cos = min(_cosine(k_lat, p_lat).min().item(),
                  _cosine(k_embs, p_embs).min().item())
    step = {"logits_max_abs_err": err, "logits_cos_min": cos,
            "logits_max_abs": logits["plain"].abs().max().item(),
            "plain_one_ulp_noise_max_abs": noise,
            "image_encode_cos_min": enc_cos,
            "own_encode_logits_max_abs_err":
                (own - logits["plain"]).abs().max().item(),
            "own_encode_logits_cos_min":
                _cosine(own, logits["plain"]).min().item(),
            "plain_side_launches": counts_plain,
            "finite": bool(torch.isfinite(own).all().item()),
            "ok": (err <= 5e-2 or err <= 2 * noise) and cos >= 0.999
            and enc_cos >= 0.999 and not any(counts_plain.values())}
    step["ok"] = step["ok"] and step["finite"]
    del plain
    ok = step["ok"] and all(v["ok"] and v["launches_ok"]
                            for v in methods.values())
    result = {"phase": "coca", "card": card, "model": COCA_MODEL,
              "weights": "seeded random init, bf16",
              "params": sum(p.numel() for p in model.parameters()),
              "build_s": build_s, "batch": COCA_GEN_BATCH,
              "seq_len": COCA_SEQ_LEN, "methods": methods,
              "captions": captions, "decoder_step": step, "ok": ok}
    _emit(result)
    del model
    if not ok:
        raise AssertionError(f"coca phase failed its checks: {result}")
    return counts


def _coca_texts(n: int, seed: int):
    """``n`` seeded captions of five to twelve words, BPE ids at CoCa's
    76 tokens (pad tails of different lengths)."""
    from xtagclip_tpu_torch.factory import get_tokenizer

    rng = np.random.default_rng(seed)
    tok = get_tokenizer(COCA_MODEL)
    return torch.from_numpy(tok([
        " ".join(rng.choice(CLIPA_WORDS, rng.integers(5, 13)))
        for _ in range(n)]).astype(np.int64))


def _coca_train_args(logs: str, train_csv: str, val_csv: str) -> list:
    """open_clip README's coca_ViT-L-14 MSCOCO fine-tune flags (batch
    128, lr 1e-5, wd 0.1, warmup 1000, contrastive weight 0, caption
    weight 1, CSV data) through cli.main, for one epoch of the seeded CSV,
    with --val-data so that evaluate runs at its end."""
    return ["--model", COCA_MODEL, "--train-data", train_csv,
            "--val-data", val_csv, "--dataset-type", "csv",
            "--csv-img-key", "filepath", "--csv-caption-key", "title",
            "--batch-size", str(COCA_BATCH), "--lr", "1e-5", "--wd", "0.1",
            "--warmup", "1000", "--coca-contrastive-loss-weight", "0",
            "--coca-caption-loss-weight", "1", "--precision", "amp_bf16",
            "--epochs", "1", "--workers", "4", "--log-every-n-steps", "1",
            "--logs", logs, "--name", "coca", "--seed", "0"]


def phase_coca_train(card: str, tmp: str, profile: bool = False) -> dict:
    """The MSCOCO fine-tune recipe of coca_ViT-L-14 through cli.main at
    full width and depth from a seeded init, on a seeded CSV of
    (COCA_WARMUP + COCA_STEPS) x 128 224x224 PNGs and captions, then its
    evaluate at the epoch's end on COCA_VAL_ROWS more, and one more
    evaluate timed (eval img/s). Samples/s and p50 step ms over the timed
    steps, peak memory, the losses, the checkpoint's bytes and seconds;
    launches against COCA_PER_STEP per step and COCA_PER_EVAL_BATCH per
    eval batch. Then one step with the kernels on and off from the same
    weights and batch (COCA_PATH_BATCH, both loss weights on), at the
    train-path bars (phase_train_path)."""
    import gc

    from xtagclip_tpu_torch.cli import main as coca_main
    from xtagclip_tpu_torch.data.datasets import CsvDataset
    from xtagclip_tpu_torch.data.registry import _loader
    from xtagclip_tpu_torch.data.transforms import (
        PreprocessCfg,
        image_transform_eval,
    )
    from xtagclip_tpu_torch.factory import get_tokenizer
    from xtagclip_tpu_torch.train.evaluate import evaluate
    from xtagclip_tpu_torch.train.logger import close_logging
    from xtagclip_tpu_torch.train.params import parse_args

    logs = os.path.join(tmp, "coca")
    rows = (COCA_WARMUP + COCA_STEPS) * COCA_BATCH
    t0 = time.perf_counter()
    train_csv = _write_val_csv(os.path.join(tmp, "coca_train"), rows,
                               np.random.default_rng(41))
    val_csv = _write_val_csv(os.path.join(tmp, "coca_val"), COCA_VAL_ROWS,
                             np.random.default_rng(42))
    write_s = time.perf_counter() - t0
    counts = {}
    try:
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        out = coca_main.main(_coca_train_args(logs, train_csv, val_csv))
        wall = time.perf_counter() - t0
        c = counts["coca_trainer"] = _counts()
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        rec = out["epochs"][0]
        tm = rec["train"]
        steps = len(tm["interval_step_s"])
        val_batches = -(-COCA_VAL_ROWS // COCA_BATCH)
        timed = tm["interval_step_s"][COCA_WARMUP:]
        model = out["state"].model
        tag = os.path.join(logs, "coca", "checkpoints", "epoch_1")
        train = {
            "wall_s": wall, "steps": steps, "step_s": tm["interval_step_s"],
            "samples_per_s": COCA_BATCH * len(timed) / sum(timed),
            "p50_step_ms": 1e3 * statistics.median(timed),
            "loss": tm["loss"], "caption_loss": tm["caption_loss"],
            "contrastive_loss": tm["contrastive_loss"],
            "grad_norm": tm["grad_norm"], "peak_mem_gb": peak,
            "resident_before_gb": resident / 1e9,
            "data_wait_ms": [1e3 * t for t in tm["data_step_s"]],
            "checkpoint_bytes": _ckpt_bytes(tag),
            "checkpoint_save_s": rec["checkpoint_s"],
            "eval_in_cli": rec["eval"], "eval_in_cli_s": rec["eval_s"],
            "launches": c,
            "launches_ok": c == _sum_counts(
                _scaled(COCA_PER_STEP, steps),
                _scaled(COCA_PER_EVAL_BATCH, val_batches)),
            "finite": all(math.isfinite(tm[k]) for k in
                          ("loss", "caption_loss", "grad_norm"))}
        shutil.rmtree(logs, ignore_errors=True)
        if profile:
            _profile_coca_step(card, out["state"])
        # evaluate again, warm (eval img/s)
        args = parse_args(["--val-data", val_csv, "--dataset-type", "csv",
                           "--batch-size", str(COCA_BATCH), "--workers", "4",
                           "--model", COCA_MODEL], include_xtag=False)
        args.checkpoint_path = None
        tok = get_tokenizer(COCA_MODEL)
        data = {"val": _loader(CsvDataset(
            val_csv, image_transform_eval(PreprocessCfg(
                **model.preprocess_cfg)), img_key="filepath",
            caption_key="title", tokenizer=tok), args, is_train=False)}
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = evaluate(model, data, 1, args, tok)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        c = counts["coca_eval"] = _counts()
        ev = {"rows": COCA_VAL_ROWS, "seconds": eval_s,
              "img_per_s": COCA_VAL_ROWS / eval_s, "metrics": metrics,
              "launches": c,
              "launches_ok": c == _want(**_scaled(COCA_PER_EVAL_BATCH,
                                                  val_batches)),
              "finite": all(math.isfinite(v) for v in metrics.values()
                            if isinstance(v, float))}
        del out, model, data
        close_logging()
        gc.collect()
        torch.cuda.empty_cache()
        path = _coca_train_path()
    finally:
        shutil.rmtree(logs, ignore_errors=True)
        for d in ("coca_train", "coca_val"):
            shutil.rmtree(os.path.join(tmp, d), ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    ok = (train["launches_ok"] and train["finite"]
          and steps == COCA_WARMUP + COCA_STEPS and ev["launches_ok"]
          and ev["finite"] and ev["metrics"]["num_samples"] == COCA_VAL_ROWS
          and path["ok"])
    result = {"phase": "coca_train", "card": card, "model": COCA_MODEL,
              "recipe": "open_clip README coca_ViT-L-14 MSCOCO fine-tune "
                        "via cli.main",
              "weights": "seeded random init", "batch": COCA_BATCH,
              "cuts": "1 epoch of 896 seeded PNG rows; kernels-on/off step "
                      f"at batch {COCA_PATH_BATCH}",
              "grad_checkpointing": False, "csv_write_s": write_s,
              "train": train, "eval": ev, "train_path": path, "ok": ok}
    _emit(result)
    if not ok:
        raise AssertionError(f"coca_train phase failed its checks: {result}")
    return counts


def _coca_train_path() -> dict:
    """One CoCa train step (contrastive weight 1, caption weight 2, JAX's
    defaults, so every tower's gradient is held) at COCA_PATH_BATCH with
    the kernels on and off from the same weights and batch, and the plain
    step on images one bf16 step up and down for each gradient's noise
    floor: phase_train_path's bars (_judge_steps)."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops import preprocess
    from xtagclip_tpu_torch.train.loop import make_train_step

    kernels = create_model(COCA_MODEL, precision="bf16", init_seed=1)
    plain = copy.deepcopy(kernels)
    set_use_kernels(plain, False)
    u8 = _coca_images(COCA_PATH_BATCH, 43)
    texts = _coca_texts(COCA_PATH_BATCH, 44).to("cuda")
    batch = {"images": preprocess.normalize_images(u8, dtype=torch.bfloat16),
             "texts": texts}
    p_images = preprocess.normalize_images_reference(u8,
                                                     dtype=torch.bfloat16)
    start = copy.deepcopy(plain.state_dict())
    runs = (("kernels", kernels, batch),
            ("plain", plain, {"images": p_images, "texts": texts}),
            ("plain_up", plain, {"images": _bf16_ulp_shift(p_images, 1),
                                 "texts": texts}),
            ("plain_down", plain, {"images": _bf16_ulp_shift(p_images, -1),
                                   "texts": texts}))
    step = make_train_step({"coca": True, "coca_caption_loss_weight": 2.0,
                            "coca_contrastive_loss_weight": 1.0})
    out = _steps_vs_plain(runs, step, plain, start)
    judged, names = _judge_steps(out)
    judged["batch"] = COCA_PATH_BATCH
    del kernels, plain, start, out
    return judged


def _profile_coca_step(card: str, state, n_steps: int = 3) -> None:
    """torch.profiler window of ``n_steps`` CoCa train steps of
    COCA_BATCH (the CLI's step) on seeded batches already on the card."""
    from xtagclip_tpu_torch.ops import preprocess
    from xtagclip_tpu_torch.train.loop import make_train_step

    u8 = _coca_images(COCA_BATCH, 45)
    texts = _coca_texts(COCA_BATCH, 46).to("cuda")
    step = make_train_step({"coca": True, "coca_caption_loss_weight": 1.0,
                            "coca_contrastive_loss_weight": 0.0})
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run():
        nonlocal state
        for _ in range(n_steps):
            batch = {"images": preprocess.normalize_images(
                u8, dtype=torch.bfloat16), "texts": texts}
            state, _ = step(state, batch, gen)

    _profile_window(f"{COCA_MODEL}: train {n_steps} steps of {COCA_BATCH}",
                    run, card, top=25)


def write_t5_tokenizer(directory: str, words, size: int = 32000) -> str:
    """A SentencePiece-style (T5) tokenizer in ``directory``, as SigLIP's
    hub repository holds one: tokenizer.json (a unigram model over
    ``size`` pieces: <pad> 0, </s> 1, <unk> 2, the ``words`` and the
    letters with and without the word-start mark, filled with unused
    pieces; the Metaspace pre-tokenizer; </s> appended) and
    tokenizer_config.json naming T5Tokenizer. Returns the directory."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import processors

    letters = [chr(c) for c in range(97, 123)]
    pieces = list(dict.fromkeys(["▁" + w for w in sorted(words)]
                                + ["▁" + c for c in letters] + letters
                                + ["▁"]))
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    vocab += [(p, -math.log(2.0 + i)) for i, p in enumerate(pieces)]
    vocab += [(f"<unused{i}>", -100.0) for i in range(size - len(vocab))]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>",
        special_tokens=[("</s>", 1)])
    os.makedirs(directory, exist_ok=True)
    tok.save(os.path.join(directory, "tokenizer.json"))
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "T5Tokenizer", "eos_token": "</s>",
                   "pad_token": "<pad>", "unk_token": "<unk>",
                   "extra_ids": 0, "model_max_length": SIGLIP_L}, f)
    return directory


def _write_siglip_hub_cache(hub: str) -> str:
    """SigLIP's tokenizer as a hub cache holds it offline
    (models--timm--ViT-B-16-SigLIP/snapshots/<revision>/ with refs/main):
    write_t5_tokenizer over the synthetic caption's and CLIPA_WORDS'
    words. Returns the snapshot directory."""
    rev = "41aec1c83b32e0a6fca20ad88ba058aa5b5ea394"
    repo = os.path.join(hub, "models--" + SIGLIP_TOKENIZER.replace("/", "--"))
    snap = write_t5_tokenizer(os.path.join(repo, "snapshots", rev),
                              ("dummy", "caption", *CLIPA_WORDS))
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(rev)
    return snap


def _cli_main_args(model: str, batch: int, steps: int, logs: str,
                   name: str, *extra) -> list:
    """cli.main on synthetic data for ``steps`` steps of ``batch``, bf16
    over fp32 masters, no checkpoint written, no eval."""
    return ["--model", model, "--dataset-type", "synthetic",
            "--train-num-samples", str(batch * steps), "--batch-size",
            str(batch), "--epochs", "1", "--lr", "1e-4", "--wd", "0.1",
            "--warmup", "10", "--precision", "amp_bf16", "--workers", "4",
            "--log-every-n-steps", "1", "--save-frequency", "0",
            "--val-frequency", "0", "--logs", logs, "--name", name,
            "--seed", "0", *extra]


def _cli_train(argv, warmup: int, batch: int) -> tuple:
    """(cli.main's result, the train record: samples/s and p50 step ms
    over the steps after ``warmup``, peak memory over what was resident,
    the losses; launches of the run)."""
    import gc

    from xtagclip_tpu_torch.cli import main as cli_main
    from xtagclip_tpu_torch.train.logger import close_logging

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        out = cli_main.main(argv)
    finally:
        close_logging()
    wall = time.perf_counter() - t0
    counts = _counts()
    tm = out["epochs"][0]["train"]
    timed = tm["interval_step_s"][warmup:]
    rec = {"wall_s": wall, "steps": len(tm["interval_step_s"]),
           "step_s": tm["interval_step_s"],
           "samples_per_s": batch * len(timed) / sum(timed),
           "p50_step_ms": 1e3 * statistics.median(timed),
           "peak_mem_gb": (torch.cuda.max_memory_allocated() - resident) / 1e9,
           "data_wait_ms": [1e3 * t for t in tm["data_step_s"]],
           "launches": counts,
           **{k: tm[k] for k in ("loss", "contrastive_loss", "distill_loss",
                                 "grad_norm", "logit_scale") if k in tm}}
    rec["finite"] = all(math.isfinite(rec[k]) for k in
                        ("loss", "contrastive_loss", "grad_norm") if k in rec)
    return out, rec


def _path_runs(kernels, plain, batch, p_batch):
    """The kernels-on/off runs of _steps_vs_plain: kernels, plain, and the
    plain step on images one bf16 step up and down (the noise floor)."""
    return (("kernels", kernels, batch), ("plain", plain, p_batch),
            ("plain_up", plain, dict(p_batch, images=_bf16_ulp_shift(
                p_batch["images"], 1))),
            ("plain_down", plain, dict(p_batch, images=_bf16_ulp_shift(
                p_batch["images"], -1))))


def _synthetic_batch(b: int, ctx: int, vocab: int, seed: int,
                     side: int = IMAGE_SIZE, pad: int = 0):
    """(uint8 images, token ids) on the card: seeded side x side images and
    ids of 5 to ``ctx`` - 1 tokens above ``pad``, padded with it."""
    rng = np.random.default_rng(seed)
    texts = np.full((b, ctx), pad, np.int64)
    for i, n in enumerate(rng.integers(5, ctx, b)):
        texts[i, :n] = rng.integers(pad + 1, vocab, n)
    images = np.random.default_rng(seed).integers(
        0, 256, (b, side, side, 3), dtype=np.uint8)
    return (torch.from_numpy(images).to("cuda"),
            torch.from_numpy(texts).to("cuda"))


def _kernels_vs_plain_step(model_name: str, b: int, args_cfg: dict,
                           precision: str = "bf16", teacher=None,
                           seed: int = 61) -> dict:
    """One train step of ``model_name`` with the kernels on and off from
    the same weights and batch (``args_cfg``; a ``teacher`` pair (kernels,
    plain) distils into each), at the train-path bars (_judge_steps)."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops import preprocess
    from xtagclip_tpu_torch.train.loop import make_train_step

    kernels = create_model(model_name, precision=precision, init_seed=1)
    plain = copy.deepcopy(kernels)
    set_use_kernels(plain, False)
    u8, texts = _model_batch(kernels, b, seed)
    batch = {"images": preprocess.normalize_images(u8, dtype=torch.bfloat16),
             "texts": texts}
    p_batch = {"images": preprocess.normalize_images_reference(
        u8, dtype=torch.bfloat16), "texts": texts}
    start = copy.deepcopy(plain.state_dict())
    steps = {m: make_train_step(args_cfg, teacher=t) for m, t in (
        ("kernels", teacher and teacher[0]), ("plain", teacher and teacher[1]))}

    def step(state, bt, gen):
        return steps["kernels" if state.model is kernels else "plain"](
            state, bt, gen)

    out = _steps_vs_plain(_path_runs(kernels, plain, batch, p_batch), step,
                          plain, start)
    judged, _ = _judge_steps(out)
    judged.update(batch=b, precision=precision)
    if kernels.logit_bias is not None:
        judged["logit_bias_grad"] = {k: out[k][1]["logit_bias"].item()
                                     for k in ("kernels", "plain")}
        judged["ok"] = judged["ok"] and all(
            v != 0.0 for v in judged["logit_bias_grad"].values())
    del kernels, plain, start, out
    return judged


def _model_batch(model, b: int, seed: int):
    """A seeded batch in ``model``'s image size, context length and
    vocabulary (an HF text tower's from its resolved config, padded with
    its pad id)."""
    from xtagclip_tpu_torch.models.hf_text import resolve_hf_config

    t = model.model_cfg["text_cfg"]
    vocab = (resolve_hf_config(t["hf_model_name"])["vocab_size"]
             if t.get("hf_model_name") else t.get("vocab_size", 49408))
    return _synthetic_batch(
        b, t.get("context_length", 77), vocab, seed,
        model.model_cfg["vision_cfg"].get("image_size", IMAGE_SIZE),
        pad=getattr(model.text, "pad_token_id", 0))


def _zoo_forward(name: str, seed: int) -> dict:
    """One bf16 forward of ``name`` (fp32 masters cast once for compute,
    as the serving entry points do) at ZOO_FWD_BATCH with the kernels on,
    then off: the launches of the kernels-on forward, the largest
    difference of the image and text features and their least per-sample
    cosine."""
    import gc

    from xtagclip_tpu_torch.factory import cast_for_compute, create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops import preprocess

    t0 = time.perf_counter()
    model = create_model(name, precision="bf16", init_seed=3)
    cast_for_compute(model, torch.bfloat16)
    model.eval()
    build_s = time.perf_counter() - t0
    u8, texts = _model_batch(model, ZOO_FWD_BATCH, seed)
    feats = {}
    with torch.inference_mode():
        for mode in ("kernels", "plain"):
            set_use_kernels(model, mode == "kernels")
            norm = (preprocess.normalize_images if mode == "kernels"
                    else preprocess.normalize_images_reference)
            _reset_counts()
            t1 = time.perf_counter()
            image, _ = model.encode_image(norm(u8, dtype=torch.bfloat16),
                                          normalize=True)
            text, _ = model.encode_text(texts, normalize=True)
            torch.cuda.synchronize()
            feats[mode] = (image, text, time.perf_counter() - t1,
                           _counts())
    (ik, tk, k_s, counts), (ip, tp, p_s, _) = feats["kernels"], feats["plain"]
    rec = {"model": name, "batch": ZOO_FWD_BATCH,
           "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
           "build_s": build_s, "forward_s": k_s, "plain_forward_s": p_s,
           "image_max_abs_diff": (ik - ip).abs().max().item(),
           "text_max_abs_diff": (tk - tp).abs().max().item(),
           "image_cos_min": _cosine(ik, ip).min().item(),
           "text_cos_min": _cosine(tk, tp).min().item(),
           "finite": bool(all(torch.isfinite(t).all().item()
                              for t in (ik, tk, ip, tp))),
           "launches": counts}
    want_flash = ZOO_FWD_FLASH.get(name, 0)
    rec["ok"] = (rec["finite"] and counts["flash_mha"] == want_flash
                 and counts["normalize_images"] == 1
                 and min(rec["image_cos_min"], rec["text_cos_min"])
                 >= ZOO_FWD_COS)
    del model, feats, ik, tk, ip, tp
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_zoo(card: str, tmp: str) -> dict:
    """The model zoo's towers at full width from a seeded init:
    EVA02-L-14 and ViTamin-L-256 through ``cli.main`` on synthetic data
    (ZOO_WARMUP + ZOO_STEPS steps at their ZOO_TRAINERS batch; samples/s,
    p50 step ms, peak memory, launches per step as ZOO_PER_STEP: #6 in
    every vision block forward and backward), one forward of each
    ZOO_FORWARD config with the kernels on and off (#6 at head dims 88,
    112 and 72 in EVA01-g, EVA02-E and ViTamin-XL; the features within
    ZOO_FWD_COS), and one train step kernels on vs off of each ZOO_PATH
    config at ZOO_PATH_BATCH at the train-path bars (MobileCLIP-S2's
    BatchNorms in train mode)."""
    import gc

    counts, runs = {}, {}
    logs = os.path.join(tmp, "zoo")
    try:
        for key, model, batch in ZOO_TRAINERS:
            out, rec = _cli_train(_cli_main_args(
                model, batch, ZOO_WARMUP + ZOO_STEPS, logs, key),
                ZOO_WARMUP, batch)
            c = counts[f"zoo_{key}"] = rec["launches"]
            rec.update(model=model, batch=batch, launches_ok=c == _want(
                **_scaled(ZOO_PER_STEP[model], rec["steps"])))
            runs[key] = rec
            del out
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    forwards = {}
    for i, name in enumerate(ZOO_FORWARD):
        rec = forwards[name] = _zoo_forward(name, 70 + i)
        counts[f"zoo_fwd_{name}"] = rec["launches"]
    paths = {}
    for name in ZOO_PATH:
        paths[name] = _kernels_vs_plain_step(name, ZOO_PATH_BATCH,
                                             {"use_tagging_loss": False})
        gc.collect()
        torch.cuda.empty_cache()
    ok = (all(r["finite"] and r["launches_ok"] for r in runs.values())
          and all(r["ok"] for r in forwards.values())
          and all(p.pop("ok") for p in paths.values()))
    result = {"phase": "zoo", "card": card, "weights": "seeded random init",
              "data": "synthetic (cli.main --dataset-type synthetic); "
                      "seeded uint8 images and token ids",
              "cuts": "one process; widths and depths as published",
              **runs, "forward": forwards, "train_path": paths, "ok": ok}
    _emit(result)
    if not ok:
        raise AssertionError(f"zoo phase failed its checks: {result}")
    return counts


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _write_recipe_checkpoint(hub: str, dev) -> tuple:
    """A seeded full-width ViT-B-32 open_clip CLIP checkpoint (fp32, the
    public repo's layout) as ``open_clip_model.safetensors`` in the
    snapshot of the registry's laion400m_e32 repo: (its tensors, path,
    seconds to write)."""
    from safetensors.torch import save_file

    from xtagclip_tpu_torch.factory import create_model

    t0 = time.perf_counter()
    sd = clip_layout_state_dict(create_model(PRETRAINED_MODEL, device=dev,
                                             init_seed=21))
    path = os.path.join(write_hub_snapshot(hub, PRETRAINED_HUB),
                        "open_clip_model.safetensors")
    save_file({k: v.contiguous() for k, v in sd.items()}, path)
    return sd, path, time.perf_counter() - t0


def _pretrained_cli(tmp: str, hub: str, dev) -> dict:
    """scar_openclip_pretrain.sh's flags through ``main_other.main`` (the
    entry of ``python -m xtagclip_tpu_torch.cli.main_other``) with its
    ``--pretrained laion400m_e32`` resolved offline from ``hub``: the
    CLIP parameters at the first step against the file, the tag head and
    TQN against a fresh seeded init, the launches, the loss."""
    from xtagclip_tpu_torch import factory
    from xtagclip_tpu_torch.cli import main_other
    from xtagclip_tpu_torch.train.logger import close_logging

    sd, path, write_s = _write_recipe_checkpoint(hub, dev)
    rng = np.random.default_rng(5)
    csvs = {split: _write_scar_split(os.path.join(tmp, split), n, rng)
            for split, n in PRETRAINED_ROWS.items()}
    argv = ["--batch-size", "4", "--workers", "4",
            "--train-data", os.path.join(tmp, "scar_train"),
            "--val-data", os.path.join(tmp, "scar_val"),
            "--precision", "amp", "--save-frequency", "250", "--warmup", "50",
            "--lr", "5e-5", "--wd", "0.1", "--epochs", "500", "--local-loss",
            "--model", PRETRAINED_MODEL, "--pretrained", PRETRAINED_TAG,
            "--prompt-template-setting", "total", "--use-tagging",
            "--use-fusion",
            # the script's "$@": this run's batch, length, files and device
            "--batch-size", str(TRAIN_BATCH), "--epochs", "1",
            "--scar-train-csv", csvs["scar_train"],
            "--scar-val-csv", csvs["scar_val"], "--device", str(dev),
            "--logs", os.path.join(tmp, "logs"), "--name", "pretrain",
            "--seed", "0", "--log-every-n-steps", "1"]
    at_first_step, load_s = {}, []
    train_one_epoch = main_other.train_one_epoch

    def first_epoch(*a, **k):
        if not at_first_step:
            model = a[0].model
            at_first_step["clip"] = clip_layout_state_dict(model)
            at_first_step["heads"] = {
                n: p.detach().clone() for n, p in model.named_parameters()
                if n.startswith(("tag_", "fusion_model."))}
        return train_one_epoch(*a, **k)

    main_other.train_one_epoch = first_epoch
    _reset_counts()
    t0 = time.perf_counter()
    try:
        with _env(HF_HUB_CACHE=hub, HF_HUB_OFFLINE="1"), \
                _timing(factory, "load_pretrained", load_s):
            out = main_other.main(argv)
    finally:
        main_other.train_one_epoch = train_one_epoch
        close_logging()
    run_s = time.perf_counter() - t0
    counts = _counts()
    clip = at_first_step["clip"]
    loaded = set(clip) == set(sd) and all(torch.equal(clip[k], sd[k])
                                          for k in sd)
    fresh = factory.create_model(PRETRAINED_MODEL, precision="bf16",
                                 device=dev, use_tagging=True,
                                 use_fusion=True, init_seed=0)
    heads_kept = all(torch.equal(p, at_first_step["heads"][n])
                     for n, p in fresh.named_parameters()
                     if n in at_first_step["heads"])
    del fresh
    (rec,) = out["epochs"]
    tm = rec["train"]
    steps = PRETRAINED_ROWS["scar_train"] // TRAIN_BATCH
    try:  # does this torch's torch.load read a .safetensors file? (JAX's
        # hub route hands it one: ROADMAP Queue 3)
        torch.load(path, map_location="cpu", weights_only=True)
        torch_load_reads = True
    except Exception:  # noqa: BLE001
        torch_load_reads = False
    res = {"entry": "xtagclip_tpu_torch.cli.main_other.main with "
                    "scar_openclip_pretrain.sh's flags",
           "pretrained": f"{PRETRAINED_TAG} -> {os.path.relpath(path, hub)}",
           "checkpoint_bytes": os.path.getsize(path),
           "checkpoint_write_s": write_s, "resolve_load_s": load_s,
           "run_s": run_s, "steps": steps,
           "samples_per_s": tm["samples_per_second"],
           "p50_step_ms": 1e3 * tm["p50_step_s"], "loss": tm["loss"],
           "eval": {k: v for k, v in rec["eval"].items()
                    if k.endswith(("top1", "tag_accuracy", "-n"))},
           "clip_params_equal_file": loaded,
           "clip_tensors": len(clip), "tag_head_kept_seeded_init": heads_kept,
           "launches": counts,
           "torch_load_reads_safetensors": torch_load_reads}
    res["ok"] = (loaded and heads_kept and len(load_s) == 1
                 and math.isfinite(tm["loss"])
                 and all(counts[k] >= steps * v
                         for k, v in PRETRAINED_PER_STEP.items()))
    return res


def _openai_serve(hub: str, ptable, dev) -> dict:
    """``create_model("ViT-B-32", pretrained="openai")`` from an fp16
    OpenAI-layout archive in the openai repo's snapshot, then one serve
    batch of 32 with the kernels on against the plain versions (the serve
    bars of phase_serve_and_path)."""
    from xtagclip_tpu_torch.factory import cast_for_compute, create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops import preprocess
    from xtagclip_tpu_torch.serving import (
        make_xtag_serve_step,
        precompute_prompt_features,
    )

    sd16 = clip_layout_state_dict(create_model(
        PRETRAINED_MODEL, device=dev, init_seed=22), torch.float16)
    path = os.path.join(write_hub_snapshot(hub, OPENAI_HUB),
                        "open_clip_pytorch_model.bin")
    torch.save({**sd16, "input_resolution": torch.tensor(IMAGE_SIZE),
                "context_length": torch.tensor(77),
                "vocab_size": torch.tensor(49408)}, path)
    with _env(HF_HUB_CACHE=hub, HF_HUB_OFFLINE="1"):
        t0 = time.perf_counter()
        model = create_model(PRETRAINED_MODEL, pretrained="openai",
                             precision="bf16", device=dev, use_tagging=True,
                             use_fusion=True, init_seed=0)
        _sync(dev)
        load_s = time.perf_counter() - t0
    got = clip_layout_state_dict(model)
    loaded = set(got) == set(sd16) and all(
        torch.equal(got[k], sd16[k].float()) for k in sd16)
    cast_for_compute(model, torch.bfloat16)
    u8 = _serve_batches(IMAGE_SIZE)[0].to(dev)
    _reset_counts()
    table = precompute_prompt_features(model, ptable, template_id=0,
                                       batch_size=PRECOMPUTE_BATCH)
    feat, tags, logits = make_xtag_serve_step(model, table)(
        preprocess.normalize_images(u8, dtype=torch.bfloat16))
    _sync(dev)
    counts = _counts()
    set_use_kernels(model, False)
    p_feat, p_tags, p_logits = make_xtag_serve_step(model, table)(
        preprocess.normalize_images_reference(u8, dtype=torch.bfloat16))
    set_use_kernels(model, True)
    res = {"entry": "create_model('ViT-B-32', pretrained='openai')",
           "archive": f"fp16 OpenAI layout, {os.path.getsize(path)} bytes",
           "resolve_load_s": load_s, "clip_params_equal_archive": loaded,
           "logits_max_abs_err": (logits.float() - p_logits.float()).abs()
           .max().item(),
           "image_feature_cos_min": _cosine(feat, p_feat).min().item(),
           "tag_agreement": (tags == p_tags).float().mean().item(),
           "finite": bool(torch.isfinite(logits.float()).all()
                          and torch.isfinite(p_logits.float()).all()),
           "launches": counts}
    res["ok"] = (loaded and res["finite"]
                 and torch.allclose(logits.float(), p_logits.float(),
                                    atol=5e-2, rtol=5e-2)
                 and res["image_feature_cos_min"] >= 0.999
                 and res["tag_agreement"] >= 0.95
                 and counts["fused_attn_half"] > 0
                 and counts["normalize_images"] == 1)
    del model
    return res


def _judge_updates(out) -> dict:
    """The train-path bars on one optimizer update kernels on vs off
    (``out``: run -> (metrics, {parameter: update}) for kernels and plain,
    each also on images one bf16 step up and down): the loss within 1e-2
    relative, the gradient norm within 2%, and each parameter's update at
    cosine >= 0.99 with the plain one, or no further from it than twice
    its one-ULP noise, the largest move of either path's update under the
    one-step shifts. An update that takes a gradient's sign (adam's first
    step, lion, adafactor's unfactored leaves) turns a near-zero element's
    rounding noise into a whole step of either sign, so a tensor whose
    gradient is mostly noise has a cosine far below 0.95 against its own
    one-ULP repeat: here the noise is the bar, with no cosine floor
    (_judge_steps keeps 0.95 for gradients). Left out, as ZERO_GRAD_PARAMS
    leaves out whole key biases: the key third of every ``in_proj`` bias
    (a softmax over keys is invariant to it, so its gradient is rounding
    noise)."""
    for _, upd in out.values():
        for n, u in upd.items():
            if n.endswith("in_proj.bias"):
                u[u.shape[0] // 3:2 * u.shape[0] // 3] = 0.0
    (mk, uk), (mp, up) = out["kernels"], out["plain"]
    names = [n for n in up if up[n].abs().max().item() > 0
             and not any(z in n for z in ZERO_GRAD_PARAMS)]
    res, failed = {}, []
    for n in names:
        cos, dist = _cos(uk[n], up[n]), _dist(uk[n], up[n])
        noise = max(_dist(out[a + s][1][n], out[a][1][n])
                    for a in ("kernels", "plain") for s in ("_up", "_down"))
        res[n] = {"cos": cos, "dist": dist, "noise_dist": noise}
        if cos < 0.99 and dist > 2 * noise:
            failed.append(n)
    under = {n: v for n, v in res.items() if v["cos"] < 0.99}
    loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    norm_rel = abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
    finite = all(math.isfinite(v) for m in (mk, mp) for v in m.values())
    judged = {"loss": [mk["loss"], mp["loss"]], "loss_rel_err": loss_rel,
              "grad_norm_rel_err": norm_rel, "updates_compared": len(names),
              "updates_missing": sorted(set(up) - set(uk)),
              "update_cos_min": min(v["cos"] for v in res.values()),
              "updates_cos_at_least_0.99": len(names) - len(under),
              "updates_within_noise": len(under) - len(failed),
              "max_dist_over_noise": max(
                  (v["dist"] / v["noise_dist"] if v["noise_dist"]
                   else math.inf for v in under.values()), default=0.0),
              "worst_under_0.99": dict(sorted(
                  under.items(), key=lambda kv: kv[1]["cos"])[:6]),
              "updates_failed": failed, "finite": finite}
    judged["ok"] = (loss_rel <= 1e-2 and norm_rel <= 2e-2 and not failed
                    and finite and not judged["updates_missing"])
    return judged


def _optimizer_run(opt: str, ptable, dev) -> dict:
    """``--opt opt`` on the XTag ViT-B-32 step: OPT_STEPS timed steps of
    32 with the kernels (samples/s and p50 over all but the first); one
    step kernels on vs off from the same weights and batch (lr 1), each
    parameter's update held at the train-path bars (_judge_updates); and
    one update from fixed fp32 gradients (constant lr 1) on the card
    against the same on the CPU, within OPT_UPDATE_REL (each tensor's
    update, by norm)."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels
    from xtagclip_tpu_torch.ops import preprocess
    from xtagclip_tpu_torch.train.loop import make_train_step
    from xtagclip_tpu_torch.train.scheduler import const_lr
    from xtagclip_tpu_torch.train.train_state import make_optimizer

    table = torch.from_numpy(ptable.astype(np.int64)).to(dev)
    host = _train_batches(ptable)

    def on_card(h, plain=False):
        norm = (preprocess.normalize_images_reference if plain
                else preprocess.normalize_images)
        return {"images": norm(h["images"].to(dev), dtype=torch.bfloat16),
                **{k: h[k].to(dev) for k in ("class_ids", "additional",
                                             "texts")}}

    model = create_model(PRETRAINED_MODEL, use_tagging=True, use_fusion=True,
                         precision="bf16", device=dev, init_seed=1)
    state = _new_train_state(model, opt)
    step = make_train_step({}, prompt_table=table)
    gen = torch.Generator(device=dev).manual_seed(0)
    _reset_counts()
    times, losses = [], []
    for i in range(OPT_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, on_card(host[i % N_TRAIN_BATCHES]), gen)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    counts = _counts()
    timed = times[1:]
    rec = {"opt": opt, "steps": OPT_STEPS, "step_s": times,
           "samples_per_s": TRAIN_BATCH * len(timed) / sum(timed),
           "p50_step_ms": 1e3 * statistics.median(timed), "losses": losses,
           "launches": counts,
           "launches_ok": counts == _want(**_scaled(PRETRAINED_PER_STEP,
                                                    OPT_STEPS))}

    # kernels on vs off: one update each from the same start, at lr 1 so
    # that p_after - p_before is the update to fp32 rounding of it (at the
    # recipe's first lr, 1e-6, it is a few ulps of p)
    t0 = time.perf_counter()
    plain = copy.deepcopy(model)
    set_use_kernels(plain, False)
    start = copy.deepcopy(plain.state_dict())
    keys = ("additional", "texts")
    h = host[0]
    out = {}
    step_one = make_train_step({})
    for name, m_ in (("kernels", model), ("plain", plain)):
        norm = (preprocess.normalize_images_reference if m_ is plain
                else preprocess.normalize_images)
        images = norm(h["images"].to(dev), dtype=torch.bfloat16)
        for shift in (0, 1, -1):
            m_.load_state_dict(start)
            before = {n: p.detach().clone() for n, p in m_.named_parameters()}
            st = _new_train_state(m_, opt, const_lr(1.0, 0, 1))
            b = {"images": _bf16_ulp_shift(images, shift) if shift
                 else images, **{k: h[k].to(dev) for k in keys}}
            _, met = step_one(st, b,
                              torch.Generator(device=dev).manual_seed(1))
            _sync(dev)
            out[name + {0: "", 1: "_up", -1: "_down"}[shift]] = (
                {k: v.item() for k, v in met.items()},
                {n: p.detach() - before[n] for n, p in m_.named_parameters()})
            m_.zero_grad(set_to_none=True)
    rec["kernels_vs_plain"] = _judge_updates(out)
    rec["kernels_vs_plain_s"] = time.perf_counter() - t0
    del plain, start, out

    # one update from fixed fp32 gradients, card vs CPU, on a slice of
    # the model that holds every kind of leaf (OPT_CPU_PARAMS)
    t0 = time.perf_counter()
    params = {n: p.detach().float().cpu() for n, p in
              model.named_parameters() if n.startswith(OPT_CPU_PARAMS)}
    g = torch.Generator().manual_seed(7)
    grads = {n: torch.randn(p.shape, generator=g) for n, p in params.items()}
    deltas = {}
    for where in (dev, "cpu"):
        named = {n: torch.nn.Parameter(p.clone().to(where))
                 for n, p in params.items()}
        tx = make_optimizer(const_lr(1.0, 0, 1), beta1=0.9, beta2=0.98,
                            eps=1e-6, weight_decay=TRAIN_WD, params=named,
                            opt=opt)
        for n, p in named.items():
            p.grad = grads[n].to(where)
        tx.update(0)
        deltas[str(where)] = {n: (p.detach().cpu() - params[n])
                              for n, p in named.items()}
    ref, got = deltas["cpu"], deltas[str(dev)]
    rel = {n: ((got[n] - ref[n]).norm() / ref[n].norm()).item()
           for n in ref if ref[n].norm() > 0}
    rec["card_vs_cpu_s"] = time.perf_counter() - t0
    rec["update_card_vs_cpu_rel_max"] = max(rel.values())
    rec["update_card_vs_cpu_worst"] = max(rel, key=rel.get)
    rec["ok"] = (rec["launches_ok"] and rec["kernels_vs_plain"]["ok"]
                 and all(math.isfinite(v) for v in losses)
                 and rec["update_card_vs_cpu_rel_max"] <= OPT_UPDATE_REL)
    return rec, model


def _export_round_trip(model, hub: str, dev) -> dict:
    """``save_hf_checkpoint`` of ``model`` into a hub snapshot, reloaded
    through ``create_model(..., pretrained="hf-hub:...")`` bit for bit."""
    from xtagclip_tpu_torch.convert.export import save_hf_checkpoint
    from xtagclip_tpu_torch.factory import create_model

    snap = write_hub_snapshot(hub, EXPORT_HUB)
    t0 = time.perf_counter()
    save_hf_checkpoint(model, snap)
    save_s = time.perf_counter() - t0
    with _env(HF_HUB_CACHE=hub, HF_HUB_OFFLINE="1"):
        t0 = time.perf_counter()
        back = create_model(PRETRAINED_MODEL,
                            pretrained=f"hf-hub:{EXPORT_HUB}",
                            precision="bf16", device=dev, use_tagging=True,
                            use_fusion=True, init_seed=9)
        _sync(dev)
        load_s = time.perf_counter() - t0
    got = dict(back.named_parameters())
    same = all(torch.equal(p, got[n]) for n, p in model.named_parameters())
    res = {"save_s": save_s, "load_s": load_s,
           "bytes": sum(os.path.getsize(os.path.join(snap, f))
                        for f in os.listdir(snap)),
           "files": sorted(os.listdir(snap)), "bit_for_bit": same,
           "ok": same}
    del back
    return res


def _int8_check(dev) -> dict:
    """ops/int8.py at INT8_SHAPE: the int32 sums on the card (cuBLASLt
    through torch._int_mm) equal the CPU's exactly, the scaled output
    within fp32 rounding."""
    from xtagclip_tpu_torch.ops import int8

    m, k, n = INT8_SHAPE
    g = torch.Generator().manual_seed(8)
    x = torch.randn(m, k, generator=g)
    w = torch.randn(k, n, generator=g) * 0.05
    xq, xs = int8.quantize_activation(x)
    wq, ws = int8.quantize_weight(w)
    ref = int8.int8_dot(xq, wq)
    args = [t.to(dev) for t in (xq, xs, wq, ws)]
    acc = int8.int8_dot(args[0], args[2])
    out = int8.int8_matmul(*args).cpu()
    want = int8.int8_matmul(xq, xs, wq, ws)
    ms = _median_ms(lambda: int8.int8_dot(args[0], args[2])) \
        if torch.device(dev).type == "cuda" else None
    res = {"shape": list(INT8_SHAPE), "int32_equal": torch.equal(
        acc.cpu(), ref), "out_max_rel_err": ((out - want).abs().max()
                                             / want.abs().max()).item(),
           "int8_dot_ms": ms}
    res["ok"] = res["int32_equal"] and res["out_max_rel_err"] <= 1e-6
    return res


def phase_pretrained(card: str, tmp: str, dev="cuda") -> dict:
    """The paper's recipes as their scripts write them: (a) the pretrain
    script's ``--pretrained laion400m_e32`` resolved offline from a hub
    cache holding a seeded full-width ViT-B-32 checkpoint (605 MB of
    safetensors) and trained one short epoch through ``main_other.main``;
    (b) ``pretrained="openai"`` from an fp16 OpenAI-layout archive, one
    serve batch kernels vs plain; (c) adamw, adam, sgd, lion and
    adafactor on the XTag step (_optimizer_run); (d) the HF export's
    round trip and int8 at a ViT-B MLP's shape. Fails unless every bar
    holds; returns the launches of (a), (b) and (c)'s timed steps."""
    root = os.path.join(tmp, "pretrained")
    os.makedirs(root)
    hub = os.path.join(root, "hub")
    t0 = time.perf_counter()
    cli = _pretrained_cli(root, hub, dev)
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptable = _scar_prompt_table()
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oai = _openai_serve(hub, ptable, dev)
    oai_s = time.perf_counter() - t0
    opts, counts, model = {}, {}, None
    for opt in OPTIMIZERS:
        t0 = time.perf_counter()
        del model
        opts[opt], model = _optimizer_run(opt, ptable, dev)
        opts[opt]["seconds"] = time.perf_counter() - t0
        counts[f"pretrained_opt_{opt}"] = opts[opt]["launches"]
    t0 = time.perf_counter()
    export = _export_round_trip(model, hub, dev)
    del model
    shutil.rmtree(root, ignore_errors=True)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    i8 = _int8_check(dev)
    int8_s = time.perf_counter() - t0
    result = {"phase": "pretrained", "card": card,
              "recipe": cli, "recipe_s": cli_s, "prompt_table_s": table_s,
              "openai": oai, "openai_s": oai_s, "export_s": export_s,
              "int8_s": int8_s,
              "optimizers": opts, "export": export, "int8": i8}
    _emit(result)
    failed = [k for k, v in (("recipe", cli), ("openai", oai),
                             *opts.items(), ("export", export),
                             ("int8", i8)) if not v["ok"]]
    if failed:
        raise AssertionError(f"pretrained phase failed: {failed}")
    return {"pretrained_recipe": cli["launches"],
            "pretrained_openai": oai["launches"], **counts}


def phase_zoo_batch_probe(card: str, tmp: str) -> dict:
    """cli.main on each ZOO_TRAINERS model for 2 steps at each batch of
    ZOO_PROBE in turn (largest first) until one fits, without
    checkpointing: the largest batch <= 128 that fits."""
    import gc

    logs = os.path.join(tmp, "probe")
    res = {}
    for key, model, _ in ZOO_TRAINERS:
        tried = []
        for batch in ZOO_PROBE:
            try:
                _, rec = _cli_train(_cli_main_args(model, batch, 2, logs,
                                                   f"b{batch}"), 1, batch)
                tried.append({"batch": batch, "fits": True,
                              "peak_mem_gb": rec["peak_mem_gb"],
                              "step_ms": 1e3 * rec["step_s"][-1]})
                break
            except torch.OutOfMemoryError:
                tried.append({"batch": batch, "fits": False})
            finally:
                shutil.rmtree(logs, ignore_errors=True)
                gc.collect()
                torch.cuda.empty_cache()
        res[model] = tried
    _emit({"phase": "zoo_batch_probe", "card": card,
           "probed": list(ZOO_PROBE), **res})
    return res


def phase_siglip(card: str, tmp: str) -> dict:
    """ViT-B-16-SigLIP and ViT-SO400M-14-SigLIP through ``cli.main
    --siglip`` at full width and depth from a seeded init on synthetic data
    (the T5 tokenizer in a temporary HF_HUB_CACHE): SIGLIP_WARMUP +
    SIGLIP_STEPS steps of 256, then SO400M_WARMUP + SO400M_STEPS of
    SO400M_BATCH; samples/s, p50 step ms, peak memory, launches per step
    (SIGLIP_PER_STEP, SO400M_PER_STEP: #4 at hidden width 4304 among them),
    the logit bias trained (moved from -10); then one B-16 step kernels on
    vs off at SIGLIP_PATH_BATCH at the train-path bars, logit_bias's
    gradient nonzero in both."""
    import gc

    hub = os.path.join(tmp, "siglip_hub")
    _write_siglip_hub_cache(hub)
    counts, runs = {}, {}
    logs = os.path.join(tmp, "siglip")
    try:
        with _env(HF_HUB_CACHE=hub):
            for key, model, batch, warm, steps, per, extra in (
                    ("siglip", SIGLIP_MODEL, SIGLIP_BATCH, SIGLIP_WARMUP,
                     SIGLIP_STEPS, SIGLIP_PER_STEP,
                     ("--loss-dist-impl", "bidir")),
                    ("so400m", SO400M_MODEL, SO400M_BATCH, SO400M_WARMUP,
                     SO400M_STEPS, SO400M_PER_STEP, ())):
                out, rec = _cli_train(_cli_main_args(
                    model, batch, warm + steps, logs, key, "--siglip",
                    *extra), warm, batch)
                c = counts[key] = rec["launches"]
                bias = out["state"].model.logit_bias.item()
                rec.update(model=model, batch=batch, logit_bias=bias,
                           launches_ok=c == _want(**_scaled(
                               per, rec["steps"])))
                runs[key] = rec
                del out
                gc.collect()
                torch.cuda.empty_cache()
        path = _kernels_vs_plain_step(SIGLIP_MODEL, SIGLIP_PATH_BATCH,
                                      {"siglip": True,
                                       "use_tagging_loss": False})
    finally:
        shutil.rmtree(logs, ignore_errors=True)
        shutil.rmtree(hub, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    ok = (path.pop("ok") and all(
        r["finite"] and r["launches_ok"] and r["logit_bias"] != -10.0
        for r in runs.values())
        and counts["so400m"]["fused_mlp"] > 0)
    result = {"phase": "siglip", "card": card, "weights": "seeded random init",
              "data": "synthetic (cli.main --dataset-type synthetic)",
              "cuts": "one process (the recipe's batch of 32k spans many "
                      "cards); depth and widths as published",
              **runs, "train_path": path, "ok": ok}
    _emit(result)
    if not ok:
        raise AssertionError(f"siglip phase failed its checks: {result}")
    return counts


def phase_siglip_batch_probe(card: str, tmp: str) -> dict:
    """cli.main --siglip on ViT-SO400M-14-SigLIP for 2 steps at each batch
    of SO400M_PROBE in turn, until one runs out of memory: the largest
    batch that fits, without and then with --grad-checkpointing (which
    checkpoints the timm trunk's blocks and the text tower's)."""
    import gc

    hub = os.path.join(tmp, "siglip_hub")
    _write_siglip_hub_cache(hub)
    logs = os.path.join(tmp, "probe")
    res = {}
    with _env(HF_HUB_CACHE=hub):
        for ckpt in (False, True):
            fits = []
            for batch in SO400M_PROBE:
                try:
                    _, rec = _cli_train(_cli_main_args(
                        SO400M_MODEL, batch, 2, logs, f"b{batch}",
                        "--siglip", *(("--grad-checkpointing",)
                                      if ckpt else ())), 1, batch)
                    fits.append({"batch": batch,
                                 "peak_mem_gb": rec["peak_mem_gb"],
                                 "step_ms": 1e3 * rec["step_s"][-1]})
                except torch.OutOfMemoryError:
                    break
                finally:
                    shutil.rmtree(logs, ignore_errors=True)
                    gc.collect()
                    torch.cuda.empty_cache()
            res["grad_checkpointing" if ckpt else "plain"] = fits
    shutil.rmtree(hub, ignore_errors=True)
    _emit({"phase": "siglip_batch_probe", "card": card,
           "model": SO400M_MODEL, "probed": list(SO400M_PROBE), **res})
    return res


def phase_distill(card: str, tmp: str) -> dict:
    """Distillation as open_clip's README documents it, through cli.main:
    student ViT-B-32 at DISTILL_BATCH, ``--distill-model ViT-L-14
    --distill-pretrained`` a .pt the port's exporter writes from a seeded
    init (1.7 GB, deleted after), synthetic data, DISTILL_WARMUP +
    DISTILL_STEPS steps: samples/s, p50 step ms, peak memory, distill_loss
    finite, launches per step (DISTILL_PER_STEP); then one step kernels on
    vs off at DISTILL_PATH_BATCH with the teacher in each, and one
    --precision pure_bf16 ViT-B-32 step kernels on vs off, at the
    train-path bars."""
    import gc

    from xtagclip_tpu_torch.convert.export import save_open_clip_checkpoint
    from xtagclip_tpu_torch.factory import cast_for_compute, create_model
    from xtagclip_tpu_torch.models.layers import set_use_kernels

    pt = os.path.join(tmp, "teacher.pt")
    logs = os.path.join(tmp, "distill")
    try:
        t0 = time.perf_counter()
        teacher = create_model(DISTILL_TEACHER, init_seed=5)
        save_open_clip_checkpoint(teacher, pt)
        write_s = time.perf_counter() - t0
        t_kernels = teacher.requires_grad_(False).eval()
        cast_for_compute(t_kernels, torch.bfloat16)
        t_plain = copy.deepcopy(t_kernels)
        set_use_kernels(t_plain, False)
        del teacher
        gc.collect()
        out, rec = _cli_train(_cli_main_args(
            DISTILL_STUDENT, DISTILL_BATCH, DISTILL_WARMUP + DISTILL_STEPS,
            logs, "distill", "--distill-model", DISTILL_TEACHER,
            "--distill-pretrained", pt), DISTILL_WARMUP, DISTILL_BATCH)
        c = rec["launches"]
        rec.update(student=DISTILL_STUDENT, teacher=DISTILL_TEACHER,
                   batch=DISTILL_BATCH, teacher_pt_bytes=os.path.getsize(pt),
                   teacher_pt_write_s=write_s,
                   launches_ok=c == _want(**_scaled(DISTILL_PER_STEP,
                                                    rec["steps"])))
        del out
        path = _kernels_vs_plain_step(DISTILL_STUDENT, DISTILL_PATH_BATCH,
                                      {"use_tagging_loss": False},
                                      teacher=(t_kernels, t_plain))
        del t_kernels, t_plain
        gc.collect()
        torch.cuda.empty_cache()
        pure = _kernels_vs_plain_step(DISTILL_STUDENT, DISTILL_PATH_BATCH,
                                      {"use_tagging_loss": False},
                                      precision="pure_bf16")
    finally:
        shutil.rmtree(logs, ignore_errors=True)
        if os.path.exists(pt):
            os.remove(pt)
        gc.collect()
        torch.cuda.empty_cache()
    ok = (rec["finite"] and rec["launches_ok"]
          and math.isfinite(rec.get("distill_loss", float("nan")))
          and path.pop("ok") and pure.pop("ok"))
    result = {"phase": "distill", "card": card,
              "recipe": "open_clip README --distill-model ViT-L-14 "
                        "--distill-pretrained openai, via cli.main",
              "weights": "seeded random init; the teacher from a seeded .pt "
                         "the port's exporter wrote",
              "data": "synthetic", "train": rec, "train_path": path,
              "pure_bf16_train_path": pure, "ok": ok}
    _emit(result)
    if not ok:
        raise AssertionError(f"distill phase failed its checks: {result}")
    return {"distill": c}


def phase_rn50(card: str) -> dict:
    """The CLIP RN50 tower (models/resnet.py) in fp32 at batch 32 on the
    card, held to the CPU's forward on the same weights: pooled features
    and tokens within 1e-3 of their largest magnitude (TF32 off). Prints
    the card's forward ms."""
    from xtagclip_tpu_torch import factory

    model = factory.create_model("RN50", device="cuda")
    cpu = factory.create_model("RN50", device="cpu", skip_init=True)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(50)
    x = torch.from_numpy(rng.standard_normal(
        (SERVE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.float32))
    with torch.inference_mode():
        got = [t.cpu() for t in model.visual(x.cuda())]
        want = cpu.visual(x)
        ms = _median_ms(lambda: model.visual(x.cuda()), reps=5, per_rep=2)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    bars = [1e-3 * max(1.0, float(w.abs().max())) for w in want]
    result = {"phase": "rn50", "card": card,
              "model": "RN50 (ModifiedResNet [3, 4, 6, 3], width 64), fp32, "
                       "seeded init", "batch": SERVE_BATCH,
              "shapes": [list(g.shape) for g in got],
              "max_abs_err_vs_cpu": errs, "bars": bars,
              "forward_ms": ms,
              "n_params": sum(p.numel() for p in model.parameters())}
    _emit(result)
    if not all(e <= b for e, b in zip(errs, bars)):
        raise AssertionError(f"rn50 phase: card and CPU differ: {result}")
    return _counts()


def phase_clipa_path(card: str):
    """At stage 2's full width, batch CLIPA_PATH_BATCH: (1) one step with
    --grad-checkpointing on and off from the same weights, batch and
    dropout seed: loss and every gradient bit for bit (deterministic
    PyTorch algorithms on, for the token embedding's scatter-add), with
    each run's peak memory; (2) one step with the kernels on and off,
    held to phase 6's bars (_judge_steps); (3) a kernels-on step at
    --force-patch-dropout 0.5 (L = 129): finite; (4) eval image features,
    kernels vs plain: cosine >= 0.999."""
    import gc

    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.models.layers import (
        set_grad_checkpointing,
        set_use_kernels,
    )
    from xtagclip_tpu_torch.ops import preprocess
    from xtagclip_tpu_torch.train.loop import make_train_step

    model = create_model("ViT-H-14-CL32-GAP", precision="bf16", init_seed=1)
    start = {k: v.detach().cpu().clone() for k, v in
             model.state_dict().items()}
    rng = np.random.default_rng(200)
    b = CLIPA_PATH_BATCH
    images = torch.from_numpy(rng.integers(0, 256, (b, IMAGE_SIZE,
                                                    IMAGE_SIZE, 3),
                                           dtype=np.uint8)).to("cuda")
    texts = np.zeros((b, 32), np.int64)
    texts[:, 0] = 49406
    texts[:, 1:21] = rng.integers(1, 49000, (b, 20))
    texts[:, 21] = 49407
    texts = torch.from_numpy(texts).to("cuda")
    norm = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.bfloat16)
    batch = {"images": preprocess.normalize_images(images, **norm),
             "texts": texts}
    p_batch = {"images": preprocess.normalize_images_reference(images,
                                                                **norm),
               "texts": texts}
    step = make_train_step({"use_tagging_loss": False})

    # (1) checkpointing on vs off: the step's loss and gradients, and the
    # memory of a forward and backward alone (the step's own peak is the
    # optimizer's, once the activations are gone): what the forward
    # leaves held for the backward, and the peak over what was resident
    remat, memory = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for on in (False, True):
            set_grad_checkpointing(model, on)
            model.load_state_dict(start)
            gc.collect()
            torch.cuda.empty_cache()
            _reset_counts()
            out = _steps_vs_plain((("run", model, batch),), step, None,
                                  None)["run"]
            remat[on] = (out, _counts())
            memory[on] = _fwd_bwd_memory(model, batch)
    finally:
        torch.use_deterministic_algorithms(False)
        set_grad_checkpointing(model, False)
    (m_off, g_off), c_off = remat[False]
    (m_on, g_on), c_on = remat[True]
    same_bits = (m_off["loss"] == m_on["loss"] and g_off.keys() == g_on.keys()
                 and all(torch.equal(g_off[n], g_on[n]) for n in g_off))
    differ = [n for n in g_off if n in g_on
              and not torch.equal(g_off[n], g_on[n])][:8]
    del remat, g_off, g_on

    # (2) kernels on vs off
    model.load_state_dict(start)
    plain = copy.deepcopy(model)
    set_use_kernels(plain, False)
    runs = (("kernels", model, batch), ("plain", plain, p_batch),
            ("plain_up", plain, dict(p_batch, images=_bf16_ulp_shift(
                p_batch["images"], 1))),
            ("plain_down", plain, dict(p_batch, images=_bf16_ulp_shift(
                p_batch["images"], -1))))
    judged, _ = _judge_steps(_steps_vs_plain(runs, step, plain, start))
    gc.collect()

    # (3) patch dropout 0.5 on the kernels
    model.load_state_dict(start)
    model.visual.patch_dropout = 0.5
    _reset_counts()
    (m_pd, _), = _steps_vs_plain((("pd", model, batch),), step, None,
                                 None).values()
    c_pd = _counts()
    model.visual.patch_dropout = 0.0

    # (4) eval image features, kernels vs plain
    model.load_state_dict(start)
    plain.load_state_dict(start)
    model.eval()
    plain.eval()
    with torch.no_grad():
        f_k, _ = model.encode_image(batch["images"], normalize=True)
        f_p, _ = plain.encode_image(p_batch["images"], normalize=True)
    feat_cos = _cosine(f_k, f_p).min().item()
    del model, plain
    gc.collect()
    torch.cuda.empty_cache()

    ok_judged = judged.pop("ok")
    pd_finite = all(math.isfinite(v) for v in m_pd.values())
    result = {"phase": "clipa_path", "card": card,
              "model": "ViT-H-14-CL32-GAP bf16 over fp32 masters, 224 px",
              "batch": b,
              "grad_checkpointing": {
                  "loss_off": m_off["loss"], "loss_on": m_on["loss"],
                  "bit_for_bit": same_bits, "differing": differ,
                  "memory_gb_off": memory[False],
                  "memory_gb_on": memory[True],
                  "launches_off": c_off, "launches_on": c_on},
              "kernels_vs_plain": judged,
              "patch_dropout_0.5": {"metrics": m_pd, "finite": pd_finite,
                                    "launches": c_pd},
              "eval_feature_cos_min": feat_cos}
    _emit(result)
    if not (same_bits and ok_judged and pd_finite and feat_cos >= 0.999
            and c_on["flash_mha"] == 2 * c_off["flash_mha"]
            == 2 * _tower_layers("ViT-H-14-CL32-GAP")[0]
            and c_pd["flash_mha"] == _tower_layers("ViT-H-14-CL32-GAP")[0]):
        raise AssertionError(f"clipa_path failed its checks: {result}")


def _digest(sd: dict) -> str:
    """sha256 of every entry of a state dict, in order."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _dist_cli(spec: dict) -> dict:
    """--dist-worker's cli task: ``main_other.main`` or ``cli.main`` on
    ``spec["argv"]``, the launches, each step's loss, throughput, peak
    memory and the final parameters' digest."""
    import torch.distributed as dist

    from xtagclip_tpu_torch.cli import main as cli_main
    from xtagclip_tpu_torch.cli import main_other
    from xtagclip_tpu_torch.parallel.sharding import full_state_dict
    from xtagclip_tpu_torch.train.logger import close_logging

    entry = {"main_other": main_other.main, "main": cli_main.main}
    real_random = random.Random
    if spec.get("seed_crops"):
        # the train transform draws its crops from an unseeded
        # random.Random (with one loader thread, in item order)
        class SeededRandom(real_random):
            def __init__(self, x=0):
                super().__init__(x)

        random.Random = SeededRandom
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        out = entry[spec["entry"]](spec["argv"])
    finally:
        random.Random = real_random
        close_logging()
    wall = time.perf_counter() - t0
    counts = _counts()
    from xtagclip_tpu_torch.core.mesh import all_gather_object

    by_rank = all_gather_object(counts)
    tm = out["epochs"][-1]["train"]
    digest = _digest(full_state_dict(out["state"].model))
    del out
    return {"distributed": dist.is_initialized(),
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "world_size": dist.get_world_size() if dist.is_initialized()
            else 1, "wall_s": wall, "launches": counts,
            "launches_by_rank": by_rank,
            "losses": tm["losses"], "steps": len(tm["losses"]),
            "samples_per_s": tm["samples_per_second"],
            "global_samples_per_s": tm["global_samples_per_second"],
            # the steps after the first (its warm-up), one a log interval
            "samples_per_s_after_first": spec["batch"] * (
                len(tm["interval_step_s"]) - 1) / sum(
                    tm["interval_step_s"][1:]),
            "p50_step_ms": 1e3 * tm["p50_step_s"],
            "step_s": tm["interval_step_s"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params_sha256": digest}


def _dist_step_runs(model_name: str, batch: int, args_cfg: dict,
                    variants, seed: int = 1, timed: int = 0,
                    deterministic: bool = False,
                    checkpointed: bool = False, wrap: bool = True,
                    precision: str = "bf16") -> dict:
    """One train step of ``model_name`` (``precision``: bf16 over fp32
    masters, or fp32; seeded init; ``checkpointed``: --grad-checkpointing)
    from the same weights,
    batch and dropout seed for each of ``variants`` ((name, fsdp flag,
    rows of the batch), ...), each wrapped as the CLIs wrap it
    (parallel/sharding.py; not with ``wrap`` off: the one-process step
    in a process whose group exists); then ``timed`` more steps timed.
    {name:
    (metrics, {parameter: whole gradient}, record)}; the record's
    launches are the first step's, its batch's normalize included."""
    import gc
    from types import SimpleNamespace

    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.ops import preprocess
    from xtagclip_tpu_torch.parallel.sharding import (
        full,
        model_shards,
        wrap_model,
    )
    from xtagclip_tpu_torch.parallel.sharding import local as sharding_local
    from xtagclip_tpu_torch.train.loop import make_train_step
    from xtagclip_tpu_torch.train.train_state import (
        create_train_state,
        make_optimizer,
    )

    out = {}
    for name, fsdp, rows in variants:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = create_model(model_name, precision=precision, init_seed=1,
                             grad_checkpointing=checkpointed,
                             **({"use_tagging": True, "use_fusion": True}
                                if "use_tagging_loss" in args_cfg else {}))
        u8, texts = _model_batch(model, batch, seed)
        ptable = None
        _reset_counts()
        b = {"images": preprocess.normalize_images(
                 u8, dtype=torch.bfloat16 if precision == "bf16"
                 else torch.float32), "texts": texts}
        if args_cfg.get("use_tagging_loss"):
            ptable = torch.from_numpy(
                _scar_prompt_table().astype(np.int64)).to("cuda")
            rng = np.random.default_rng(seed)
            b.update(_tag_batch(rng, batch))
        b = {k: v[rows] for k, v in b.items()}
        ddp = wrap_model(model, SimpleNamespace(fsdp=fsdp)) if wrap else None
        tx = make_optimizer(lambda _: 2.048e-4, beta2=0.95, eps=1e-8,
                            weight_decay=0.2,
                            params=dict(model.named_parameters()))
        state = create_train_state(model, tx, ddp)
        step = make_train_step(args_cfg, prompt_table=ptable,
                               deterministic=deterministic)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        state, m = step(state, b, gen)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated() / 1e9
        launches = _counts()
        metrics = {k: v.item() for k, v in m.items()}
        shards = model_shards(model)
        grads = {n: full(p.grad, shards.get(n)).float().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        rec = {"launches_first_step": launches,
               "step_peak_mem_gb": step_peak,
               "param_gb": sum(sharding_local(p).numel() * p.element_size()
                               for p in model.parameters()) / 1e9}
        if timed:
            t0 = time.perf_counter()
            for _ in range(timed):
                state, m = step(state, b, gen)
            m["loss"].item()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / timed
            rec.update(step_ms=1e3 * dt, samples_per_s=len(u8[rows]) / dt)
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[name] = (metrics, grads, rec)
        del model, state, ddp, tx, step, b
    return out


def _dist_judge(got, ref) -> dict:
    """Phase 6's bars between two ``_dist_step_runs`` results: loss within
    1e-2 relative, gradient norm within 2%, each gradient that is nonzero
    on the reference side (but the ZERO_GRAD_PARAMS) at cosine >= 0.99."""
    (mg, gg, _), (mr, gr, _) = got, ref
    names = [n for n in gr if gr[n].abs().max().item() > 0
             and not any(z in n for z in ZERO_GRAD_PARAMS)]
    cos = {n: _cos(gg[n], gr[n]) for n in names}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
    res = {"loss": [mg["loss"], mr["loss"]],
           "grad_norm": [mg["grad_norm"], mr["grad_norm"]],
           "loss_rel_err": abs(mg["loss"] - mr["loss"]) / abs(mr["loss"]),
           "grad_norm_rel_err": abs(mg["grad_norm"] - mr["grad_norm"])
           / mr["grad_norm"], "grads_compared": len(names),
           "grads_missing": sorted(set(gr) - set(gg)),
           "grad_cos_min": min(cos.values()), "worst_cos": dict(worst)}
    res["ok"] = (res["loss_rel_err"] <= 1e-2
                 and res["grad_norm_rel_err"] <= 2e-2
                 and res["grad_cos_min"] >= 0.99
                 and not res["grads_missing"]
                 and all(math.isfinite(v) for v in (*res["loss"],
                                                    *res["grad_norm"])))
    return res


def _tag_batch(rng, b: int) -> dict:
    """Class ids and one tag per category, on the card."""
    additional = np.zeros((b, 22), np.float32)
    for off, size in zip((0, 3, 7, 10, 14, 18), (3, 4, 3, 4, 4, 4)):
        additional[np.arange(b), off + rng.integers(0, size, b)] = 1.0
    return {"class_ids": torch.from_numpy(rng.integers(0, 3, b)).cuda(),
            "additional": torch.from_numpy(additional).cuda()}


def _dist_gloo2(spec: dict) -> dict:
    """--dist-worker's gloo2 task, on 2 ranks of one card: rank 0 first
    runs the one-process step on the concatenated batch; then both join
    a gloo group (core/mesh.py ``init_distributed``) and run the DDP step
    on their halves; rank 0 judges."""
    import torch.distributed as dist
    from types import SimpleNamespace

    from xtagclip_tpu_torch.core.mesh import init_distributed

    b = 2 * DIST_GLOO_BATCH
    cfg = {"use_tagging_loss": True}
    rank = int(os.environ["RANK"])
    ref = _dist_step_runs(
        "ViT-B-32", b, cfg, [("one_process", False, slice(0, b))],
        deterministic=True)["one_process"] if rank == 0 else None
    args = SimpleNamespace(device="cuda", dist_url=None, dist_backend="gloo",
                           no_set_device_rank=True)
    init_distributed(args)
    rows = slice(rank * DIST_GLOO_BATCH, (rank + 1) * DIST_GLOO_BATCH)
    got = _dist_step_runs(
        "ViT-B-32", b, {**cfg, "world_size": 2, "rank": rank},
        [("two_ranks", False, rows)], deterministic=True)["two_ranks"]
    res = {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
           "launches": got[2]["launches_first_step"]}
    if rank == 0:
        res.update(_dist_judge(got, ref))
    dist.barrier()
    return res


def _dist_compare(spec: dict) -> dict:
    """--dist-worker's compare task: one step of ``spec["model"]`` with
    and without --fsdp (``_dist_step_runs``), judged at phase 6's bars."""
    cfg = {"world_size": 1, "rank": 0, "local_loss": True}
    b = spec["batch"]
    runs = _dist_step_runs(spec["model"], b, cfg,
                           [("ddp", False, slice(0, b)),
                            ("fsdp", True, slice(0, b))],
                           timed=DIST_TIMED_STEPS, checkpointed=True)
    res = _dist_judge(runs["fsdp"], runs["ddp"])
    res.update({k: runs[k][2] for k in runs})
    return res


def dist_worker(spec_path: str) -> int:
    """Run the tasks of the JSON spec at ``spec_path`` (launched by
    phase_dist, under the launcher or not), in order, and write rank 0's
    results, one a task, to its ``out``."""
    with open(spec_path) as f:
        spec = json.load(f)
    tasks = {"cli": _dist_cli, "compare": _dist_compare,
             "gloo2": _dist_gloo2, "tp_step": _tp_step}
    out = [tasks[name](task) for name, task in spec["tasks"]]
    if int(os.environ.get("RANK", "0")) == 0:
        with open(spec["out"], "w") as f:
            json.dump(out, f)
    return 0


def _run_dist(tmp: str, name: str, tasks: list, nproc=None,
              env=None) -> list:
    """chip_smoke.py --dist-worker on ``tasks`` ((task, spec), ...): under
    ``python -m torch.distributed.run --standalone --nproc_per_node
    nproc``, or launcher-free without ``nproc``. Its output goes to a log
    in ``tmp``; a worker that fails or outlasts DIST_TIMEOUT fails the
    phase."""
    out = os.path.join(tmp, f"{name}.out.json")
    path = os.path.join(tmp, f"{name}.spec.json")
    with open(path, "w") as f:
        json.dump({"tasks": tasks, "out": out}, f)
    launcher = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(nproc)] if nproc else [
                    sys.executable]
    cmd = launcher + [os.path.abspath(__file__), "--dist-worker", path]
    log = os.path.join(tmp, f"{name}.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                env={**os.environ, **(env or {})},
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=DIST_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = "timeout"
    if rc != 0:
        with open(log) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"dist worker {name} ({' '.join(cmd)}) "
                             f"ended {rc}:\n{tail}")
    with open(out) as f:
        return json.load(f)


def _scar_task(root: str, csv_file: str, logs: str, name: str,
               *extra) -> list:
    """--dist-worker's ``cli`` task: ``main_other`` with
    scar_openclip_pretrain.sh's flags on the scar split at ``root`` /
    ``csv_file`` (one loader thread, seeded crops, TRAIN_BATCH), run
    ``name`` under ``logs``, with ``extra`` flags."""
    argv = ["--batch-size", str(TRAIN_BATCH), "--workers", "1",
            "--train-data", root, "--scar-train-csv", csv_file,
            "--precision", "amp", "--save-frequency", "250", "--warmup", "50",
            "--lr", "5e-5", "--wd", "0.1", "--epochs", "1", "--local-loss",
            "--model", "ViT-B-32", "--prompt-template-setting", "total",
            "--use-tagging", "--use-fusion", "--log-every-n-steps", "1",
            "--seed", "0", "--logs", logs, "--name", name, *extra]
    return ["cli", {"entry": "main_other", "batch": TRAIN_BATCH,
                    "seed_crops": True, "argv": argv}]


def phase_dist(card: str, tmp: str, full_depth: bool = False) -> dict:
    """Phase 24 (module doc): (a) DDP at world size 1 against the
    launcher-free run, (b) FSDP2 at world size 1 on the CLIPA recipe (in
    the launcher's process that ran (a)), (c) two ranks over gloo on the
    card, and in (c)'s two processes phase 25's (b) against (a)'s
    launcher-free run, printed as the ``tp`` line. Returns the launches
    of each run."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the workers are other processes
    d = os.path.join(tmp, "dist")
    os.makedirs(d)
    rng = np.random.default_rng(7)
    root = os.path.join(d, "scar_train")
    csv_file = _write_scar_split(root, DIST_ROWS, rng)
    shards = _write_wds_shards(os.path.join(d, "shards"), DIST_CLIPA_STEPS,
                               CLIPA_BATCH, rng)
    logs = os.path.join(d, "logs")

    def scar(name, *extra):
        return _scar_task(root, csv_file, logs, name, *extra)

    clipa = "ViT-H-14-CL32-GAP"
    b_argv = _clipa_args(2, logs, shards=shards)
    i = b_argv.index("--pretrained")
    b_argv = b_argv[:i] + b_argv[i + 2:] + [
        "--fsdp", "--save-frequency", "0", "--val-frequency", "0",
        "--name", "clipa_fsdp"]
    b_argv[b_argv.index("--train-num-samples") + 1] = str(
        DIST_CLIPA_STEPS * CLIPA_BATCH)
    env = {} if full_depth else {
        "XTAGCLIP_EXTRA_CONFIGS": _depth_cut_configs(d)}
    free, = _run_dist(d, "launcher_free", [scar("free")])
    ddp, fsdp, compare = _run_dist(d, "launcher", [
        scar("ddp"),
        ["cli", {"entry": "main", "batch": CLIPA_BATCH, "argv": b_argv}],
        ["compare", {"model": clipa, "batch": CLIPA_BATCH}]], 1, env)
    gloo, tp, zoo = _run_dist(d, "gloo2", [
        ["gloo2", {}], scar("tp", *TP_FLAGS),
        ["tp_step", {"model": "EVA02-L-14", "batch": TP_ZOO_BATCH,
                     "trunk_layers": TP_ZOO_LAYERS}]], 2)

    steps = DIST_ROWS // TRAIN_BATCH
    per_step = _paths()["b32"]["per_step"]
    a = {"free": free, "ddp": ddp,
         "losses_bit_equal": free["losses"] == ddp["losses"],
         "params_bit_equal": free["params_sha256"] == ddp["params_sha256"],
         "launches_equal": free["launches"] == ddp["launches"],
         "launches_cover_steps": all(
             ddp["launches"][k] >= steps * v for k, v in per_step.items()
             if v),
         "ddp_samples_per_s_ratio": ddp["samples_per_s_after_first"]
         / free["samples_per_s_after_first"],
         "ddp_p50_step_ratio": ddp["p50_step_ms"] / free["p50_step_ms"]}
    a["ok"] = (a["losses_bit_equal"] and a["params_bit_equal"]
               and a["launches_equal"] and a["launches_cover_steps"]
               and not free["distributed"] and ddp["distributed"]
               and ddp["backend"] == "nccl" and len(ddp["losses"]) == steps)
    with _env(**env):
        want_b = _want(**_scaled(_clipa_per_step(clipa), DIST_CLIPA_STEPS))
        layers = _tower_layers(clipa)
    b = {"cli": fsdp, "compare": compare,
         "depth": "full" if full_depth else "half (CLIPA_DEPTH_CUT)",
         "layers": layers, "data": f"{DIST_CLIPA_STEPS} seeded tar shards",
         "launches_ok": fsdp["launches"] == want_b,
         "fsdp_samples_per_s_ratio": compare["fsdp"]["samples_per_s"]
         / compare["ddp"]["samples_per_s"],
         "fsdp_peak_mem_ratio": compare["fsdp"]["peak_mem_gb"]
         / compare["ddp"]["peak_mem_gb"]}
    b["ok"] = (b["launches_ok"] and compare["ok"] and fsdp["distributed"]
               and len(fsdp["losses"]) == DIST_CLIPA_STEPS
               and all(math.isfinite(v) for v in fsdp["losses"]))
    c = dict(gloo, batch_per_rank=DIST_GLOO_BATCH)
    c["ok"] = gloo["ok"] and gloo["backend"] == "gloo" \
        and gloo["launches"] == per_step
    result = {"phase": "dist", "card": card,
              "a_ddp_world1_vs_launcher_free": a,
              "b_fsdp_world1_clipa": b, "c_two_ranks_gloo": c,
              "ok": a["ok"] and b["ok"] and c["ok"]}
    _emit(result)
    tp_b = _tp_scar_judge(free, tp, steps)
    zoo["ok"] = zoo["ok"] and _launched_zoo(zoo)
    _emit({"phase": "tp", "card": card, "b_scar_model_parallel_2": tp_b,
           "d_zoo_eva02_l_model_parallel_2": zoo,
           "ok": tp_b["ok"] and zoo["ok"]})
    result["ok"] = result["ok"] and tp_b["ok"] and zoo["ok"]
    shutil.rmtree(d, ignore_errors=True)
    if not result["ok"]:
        raise AssertionError(f"dist phase failed its checks: {result}")
    return {"dist_ddp": ddp["launches"], "dist_fsdp": fsdp["launches"],
            "dist_gloo2": gloo["launches"], "tp_scar": tp["launches"],
            "tp_zoo": zoo["launches_by_rank"][0]}


# ---- tensor parallelism (--model-parallel) --------------------------------

TP_N = 2  # the model axis of the tp phase's shards
# --tp-only's uneven split: ViT-B-16-plus-240 at --model-parallel 4 (its
# vision tower's 14 heads: 4, 4, 3, 3 on the non-fused route; its text
# tower's 10: 3, 3, 2, 2 on the fused halves' partial modes)
TP_UNEVEN_MODEL = "ViT-B-16-plus-240"
TP_UNEVEN_N = 4
TP_UNEVEN_HEADS = {"visual": [4, 4, 3, 3], "text": [3, 3, 2, 2]}
# --tp-only's replication: swin_base_patch4_window7_224 (stages of 4, 8,
# 16 and 32 heads) at --model-parallel 8, cut to one block a stage: its
# first stage's attention (4 heads) is replicated whole on every rank,
# the rest split; eight gloo ranks share the card
TP_SWIN_MODEL = "swin_base_patch4_window7_224"
TP_SWIN_N, TP_SWIN_BATCH = 8, 16
TP_STEPS = 8  # --tp-nccl: steps of the scar flags a data rank
# (d) tp_zoo: EVA02-L-14's step at this batch, its vision trunk cut to
# TP_ZOO_LAYERS blocks in the no-argument run; with --tp-zoo-only the
# three models at full depth (tp_step specs). mt5-xl's T5 at random init
# is ill-conditioned in bf16: 24 blocks of unscaled attention make its
# one-process bf16 step differ from the fp32 one by more than phase 6's
# bars allow, so its split is judged in fp32 (T5 runs no kernel), beside
# the bf16 one-process step's own distance from fp32 (``bf16_noise``)
TP_ZOO_BATCH, TP_ZOO_LAYERS, TP_ZOO_MT5_BATCH = 32, 2, 8
TP_ZOO_MODELS = (
    ("eva02_l", {"model": "EVA02-L-14", "batch": TP_ZOO_BATCH}),
    ("so400m", {"model": "ViT-SO400M-14-SigLIP", "batch": TP_ZOO_BATCH}),
    ("mt5_xl", {"model": "mt5-xl-ViT-H-14", "batch": TP_ZOO_MT5_BATCH,
                "precision": "fp32", "bf16_noise": True}))


def _tp_shards():
    from xtagclip_tpu_torch.parallel.sharding import ModelShard

    return {"qkv_w": ModelShard(1, qkv=True), "qkv_b": ModelShard(0, True),
            "rows": ModelShard(0), "cols": ModelShard(1),
            "col_b": ModelShard(0), "dqkv": ModelShard(2, qkv=True)}


def _tp_piece(t, kind, r, n=TP_N):
    from xtagclip_tpu_torch.parallel.sharding import model_piece

    return model_piece(t, _tp_shards()[kind], r, n).contiguous()


def _tp_kernel_cases(gen):
    """The partial modes' cases at the sharded path shapes (N = TP_N):
    (name, shape, whole args, rank -> partial args, flops, bytes, combine,
    library) where ``combine(partials, whole args)`` gives what the
    whole-width kernel gives and ``library`` is one PyTorch call computing
    rank 0's function, or None."""
    import torch.nn.functional as F

    from xtagclip_tpu_torch.models.text import build_causal_mask
    from xtagclip_tpu_torch.parallel.sharding import ModelShard, model_whole

    dev, bf, n = "cuda", torch.bfloat16, TP_N

    def rnd(shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def finish(x, part_sum, bias):
        return (x.float() + (part_sum + bias.float())).to(x.dtype)

    cases = []
    for tower, b, l, d, h, causal in (
            ("vision", TRAIN_BATCH, 50, 768, 12, False),
            ("text", TRAIN_BATCH, 77, 512, 8, True)):
        mask = build_causal_mask(l, dev) if causal else None
        x, g = rnd((b, l, d), dtype=bf), rnd((b, l, d), dtype=bf)
        ls, lb = 1 + rnd(d, 0.1), rnd(d, 0.1)
        wqkv, bqkv = rnd((d, 3 * d), d**-0.5, bf), rnd(3 * d, 0.1)
        wout, bout = rnd((d, d), d**-0.5, bf), rnd(d, 0.1)
        hl, dl = h // n, d // n

        def fwd_args(r, x=x, ls=ls, lb=lb, wqkv=wqkv, bqkv=bqkv, wout=wout,
                     bout=bout, mask=mask, hl=hl):
            return (x, ls, lb, _tp_piece(wqkv, "qkv_w", r),
                    _tp_piece(bqkv, "qkv_b", r), _tp_piece(wout, "rows", r),
                    bout, mask, hl, 1e-5)

        def bwd_args(r, x=x, g=g, ls=ls, lb=lb, wqkv=wqkv, bqkv=bqkv,
                     wout=wout, mask=mask, hl=hl):
            return (x, g, ls, lb, _tp_piece(wqkv, "qkv_w", r),
                    _tp_piece(bqkv, "qkv_b", r), _tp_piece(wout, "rows", r),
                    mask, hl, 1e-5)

        def fwd_combine(parts, whole):
            return finish(whole[0], sum(parts), whole[6])

        def bwd_combine(parts, whole):
            g = whole[1]
            dx = (g.float() + sum(p[0] for p in parts)).to(g.dtype)
            return (dx, model_whole([p[1] for p in parts],
                                    ModelShard(2, True)),
                    torch.cat([p[2] for p in parts]), parts[0][3],
                    sum(p[4] for p in parts), sum(p[5] for p in parts))

        label = (f"{tower} B={b} L={l} D={d} H_l={hl} of {h}"
                 f"{' causal' if causal else ''}, N={n}")
        flops = 2 * b * l * dl * (4 * d + 2 * l)
        nbytes = (2 * b * l * d + 4 * b * l * d + 2 * 4 * d * dl
                  + 4 * (2 * d + 3 * dl) + (4 * l * l if causal else 0))
        cases.append(("fused_attn_half", label,
                      (x, ls, lb, wqkv, bqkv, wout, bout, mask, h, 1e-5),
                      fwd_args, flops, nbytes, fwd_combine, None))
        flops = 2 * b * l * dl * (8 * d + 6 * l)
        nbytes = (2 * 2 * b * l * d + 2 * 4 * d * dl + 4 * b * l * d
                  + 2 * 3 * b * l * dl + 4 * d * dl + 4 * 8 * d
                  + (4 * l * l if causal else 0))
        cases.append(("fused_attn_half_bwd", label,
                      (x, g, ls, lb, wqkv, bqkv, wout, mask, h, 1e-5),
                      bwd_args, flops, nbytes, bwd_combine, None))
    for tower, rows, d in (("vision", TRAIN_BATCH * 50, 768),
                           ("text", TRAIN_BATCH * 77, 512)):
        hd = 4 * d
        x = rnd((rows, d), dtype=bf)
        ls, lb = 1 + rnd(d, 0.1), rnd(d, 0.1)
        w1, b1 = rnd((d, hd), d**-0.5, bf), rnd(hd, 0.1)
        w2, b2 = rnd((hd, d), hd**-0.5, bf), rnd(d, 0.1)

        def half_args(r, x=x, ls=ls, lb=lb, w1=w1, b1=b1, w2=w2, b2=b2):
            return (x, ls, lb, _tp_piece(w1, "cols", r),
                    _tp_piece(b1, "col_b", r), _tp_piece(w2, "rows", r), b2,
                    "gelu", 1e-5)

        cases.append((
            "fused_mlp_half", f"{tower} N={rows} D={d} Hd={hd // n} of {hd} "
            f"gelu, N_model={n}",
            (x, ls, lb, w1, b1, w2, b2, "gelu", 1e-5), half_args,
            4 * rows * d * hd // n,
            2 * rows * d + 4 * rows * d + 2 * 2 * d * hd // n
            + 4 * (2 * d + hd // n),
            lambda parts, whole: finish(whole[0], sum(parts), whole[6]),
            None))
    # ViT-H-14's vision MLP at stage 2 (batch 32, L = 257), hidden 5120
    rows, d, hd = CLIPA_PATH_BATCH * 257, 1280, 5120
    x = rnd((rows, d), dtype=bf)
    w1, b1 = rnd((d, hd), d**-0.5, bf), rnd(hd, 0.1)
    w2, b2 = rnd((hd, d), hd**-0.5, bf), rnd(d, 0.1)

    def mlp_args(r, x=x, w1=w1, b1=b1, w2=w2, b2=b2):
        return (x, _tp_piece(w1, "cols", r), _tp_piece(b1, "col_b", r),
                _tp_piece(w2, "rows", r), b2, "gelu")

    cases.append((
        "fused_mlp", f"ViT-H-14 vision N={rows} D={d} Hd={hd // n} of {hd} "
        f"gelu, N_model={n}", (x, w1, b1, w2, b2, "gelu"), mlp_args,
        4 * rows * d * hd // n,
        2 * rows * d + 4 * rows * d + 2 * 2 * d * hd // n + 4 * hd // n,
        lambda parts, whole: (sum(parts) + whole[4].float()).to(bf), None))
    # flash attention on ViT-H-14's local heads, 8 of 16 heads of 80: q, k,
    # v column views of a rank's [B, L, 3 x 640] projection, as the
    # sharded block makes them
    b, l, h, dh = CLIPA_PATH_BATCH, 257, 16, 80
    qkv = rnd((b, l, 3 * h * dh), dtype=bf)

    def heads(t, hh):
        return tuple(p.reshape(b, l, hh, dh)
                     for p in t.split(hh * dh, dim=-1))

    def flash_args(r, qkv=qkv):
        return heads(_tp_piece(qkv, "dqkv", r), h // n)

    local = flash_args(0)
    sdpa_in = [t.transpose(1, 2) for t in local]
    cases.append((
        "flash_mha", f"ViT-H-14 vision ({b}, {h // n} of {h}, {l}, {dh}), "
        f"N_model={n}", heads(qkv, h), flash_args,
        4 * b * (h // n) * l * l * dh, 2 * 4 * b * (h // n) * l * dh,
        lambda parts, whole: torch.cat(parts, dim=2),
        lambda a=sdpa_in: F.scaled_dot_product_attention(*a)))
    cases += _tp_zoo_flash_cases(rnd)
    return cases


def _tp_zoo_flash_cases(rnd):
    """#6 forward and backward on EVA02-L-14's local heads at the tp_zoo
    step's shape, 8 of 16 heads of 64 at L = 257 (column views of a
    rank's q|k|v projection; the backward from the rank's own forward,
    as the sharded trunk runs it), each rank's against the whole-head
    kernel's heads. Library yardsticks: SDPA's forward, and its backward
    through autograd, on rank 0's heads."""
    import torch.nn.functional as F

    from xtagclip_tpu_torch.ops import flash_attn

    b, l, h, dh, n = TP_ZOO_BATCH, 257, 16, 64, TP_N
    hl = h // n
    qkv = rnd((b, l, 3 * h * dh), dtype=torch.bfloat16)

    def heads(t, hh):
        return tuple(p.reshape(b, l, hh, dh)
                     for p in t.split(hh * dh, dim=-1))
    do = rnd((b, l, h, dh), dtype=torch.bfloat16)

    def local(r):
        return heads(_tp_piece(qkv, "dqkv", r), hl)

    def fwd_args(r):
        return local(r)

    whole_q = heads(qkv, h)
    o, lse = flash_attn._flash_fwd(*whole_q, "blhd", with_lse=True)
    rank_fwd = [flash_attn._flash_fwd(*local(r), "blhd", with_lse=True)
                for r in range(n)]

    def bwd_args(r):
        ro, rlse = rank_fwd[r]
        return (*local(r), ro, rlse,
                do[:, :, r * hl:(r + 1) * hl].contiguous(), "blhd")

    sdpa_in = [t.transpose(1, 2) for t in local(0)]
    leaves = [t.detach().clone().requires_grad_(True) for t in sdpa_in]
    do_t = bwd_args(0)[5].transpose(1, 2)
    with torch.inference_mode(False), torch.enable_grad():
        sdpa_out = F.scaled_dot_product_attention(*leaves)

    def sdpa_bwd(out=sdpa_out, leaves=leaves, do_t=do_t):
        with torch.inference_mode(False), torch.enable_grad():
            return torch.autograd.grad(out, leaves, do_t, retain_graph=True)

    label = f"EVA02-L-14 vision ({b}, {hl} of {h}, {l}, {dh}), N_model={n}"
    elems = b * hl * l * dh
    return [
        ("flash_mha", label, whole_q, fwd_args, 4 * b * hl * l * l * dh,
         2 * 4 * elems, lambda parts, whole: torch.cat(parts, dim=2),
         lambda a=sdpa_in: F.scaled_dot_product_attention(*a)),
        ("flash_mha_bwd", label, (*whole_q, o, lse, do, "blhd"), bwd_args,
         10 * b * hl * l * l * dh, 8 * 2 * elems + 4 * b * hl * l,
         lambda parts, whole: tuple(torch.cat([p[i] for p in parts], dim=2)
                                    for i in range(3)), sdpa_bwd)]


def phase_tp_kernels(card: str) -> list:
    """The tp phase's (a) (module doc): each partial-mode kernel at its
    sharded path shape against its plain version, and the shards'
    partials, summed and finished as the block finishes them, against the
    whole-width kernel; both within atol = max|ref|/128, rtol 1e-2. Rows
    in the ``kernels`` line's format, with ``tp`` holding the whole-width
    check."""
    peak_flops, peak_rate = _peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(18)
    fns = _kernel_fns()
    rows = []
    cases = _tp_kernel_cases(gen)  # outside inference mode: the library
    # row of flash attention's backward runs autograd on its own leaves
    with torch.inference_mode():
        for name, shape, whole, rank_args, flops, nbytes, combine, \
                library in cases:
            kernel, plain = fns[name]
            partial = {} if name.startswith("flash_mha") else {
                "partial": True}
            parts, checks = [], []
            for r in range(TP_N):
                a = rank_args(r)
                out = kernel(*a, **partial)
                ref = plain(*a, **partial)
                outs, refs = ((out, ref) if isinstance(out, tuple)
                              else ((out,), (ref,)))
                checks += [_close(o, f) for o, f in zip(outs, refs)]
                parts.append(out)
            got = combine(parts, whole)
            want = kernel(*whole)
            torch.cuda.synchronize()
            gots, wants = ((got, want) if isinstance(got, tuple)
                           else ((got,), (want,)))
            vs_whole = [_close(o, w) for o, w in zip(gots, wants)]
            bad = [c for c in checks + vs_whole if not c[0]]
            if bad:
                raise AssertionError(
                    f"tp {name} [{shape}]: partial kernel vs plain {checks}"
                    f", shards vs whole-width kernel {vs_whole}")
            t_flops, t_bytes = flops / peak_flops["bf16"], nbytes / peak_rate
            source, replaces = _KERNEL_META[name]
            a0 = rank_args(0)
            rows.append({
                "name": name, "shape": shape, "card": card, "route": "cuda",
                "peak_type": "bf16", "source": source, "replaces": replaces,
                "launches": None,
                "max_abs_err": max(c[1] for c in checks),
                "atol": max(c[2] for c in checks),
                "tp": {"mode": "partial" if partial else "local heads",
                       "model_size": TP_N,
                       "vs_whole_max_abs_err": max(c[1] for c in vs_whole),
                       "vs_whole_atol": max(c[2] for c in vs_whole)},
                **_times(lambda: kernel(*a0, **partial),
                         lambda: plain(*a0, **partial), library),
                "bound_ms": 1e3 * max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            })
    _emit({"phase": "tp_kernels", "card": card, "rows": len(rows),
           "ok": True})
    return rows


@contextlib.contextmanager
def _trunk_layers(model_name: str, layers):
    """``model_name``'s EVA vision trunk cut to ``layers`` blocks, or its
    Swin trunk to ``layers`` blocks a stage, while the context lasts
    (None: as it is)."""
    if layers is None:
        yield
        return
    from xtagclip_tpu_torch.factory import get_model_config
    from xtagclip_tpu_torch.models import eva, swin

    timm_name = get_model_config(model_name)["vision_cfg"]["timm_model_name"]
    if timm_name.startswith("swin_"):
        whole = swin.SwinTrunk
        swin.SwinTrunk = functools.partial(whole, depths=(layers,) * 4)
        try:
            yield
        finally:
            swin.SwinTrunk = whole
        return
    cfg = eva.EVA_CONFIGS[timm_name]
    whole = cfg["layers"]
    cfg["layers"] = layers
    try:
        yield
    finally:
        cfg["layers"] = whole


def _tp_step(spec: dict) -> dict:
    """--dist-worker's tp_step task, on ``spec["model_parallel"]`` ranks
    of one card (TP_N by default): rank 0 first
    runs the one-process step of ``spec["model"]`` (``spec["precision"]``,
    bf16 over fp32 masters by default; --grad-checkpointing; batch
    ``spec["batch"]``; its EVA trunk cut to ``spec["trunk_layers"]``
    blocks where given), unwrapped, so that a group may exist already;
    then all join a gloo group at that --model-parallel (or keep the one
    they are in) and run the step on the whole batch with the towers
    split; rank 0 judges at phase 6's bars. Each rank's peak memory and
    parameter bytes beside the one-process ones. With
    ``spec["bf16_noise"]`` (an fp32 comparison) rank 0 also judges the
    one-process bf16 step against the fp32 one, at the same bars: what
    bf16's rounding alone moves (recorded, not a check)."""
    import gc
    from types import SimpleNamespace

    import torch.distributed as dist

    from xtagclip_tpu_torch.core.mesh import all_gather_object, init_distributed

    t0 = time.perf_counter()
    b, name, cfg = spec["batch"], spec["model"], {"local_loss": True}
    prec = spec.get("precision", "bf16")
    n_model = spec.get("model_parallel", TP_N)
    rank = int(os.environ["RANK"])
    ref = noise = None
    with _trunk_layers(name, spec.get("trunk_layers")):
        if rank == 0:  # its gradients wait on the host: peaks are the steps'
            runs = {}
            for p in (prec, "bf16") if spec.get("bf16_noise") else (prec,):
                m, g, rec = _dist_step_runs(
                    name, b, cfg, [("one_process", False, slice(0, b))],
                    checkpointed=True, wrap=False,
                    precision=p)["one_process"]
                runs[p] = (m, {k: v.cpu() for k, v in g.items()}, rec)
                del g
                gc.collect()
            ref = runs[prec]
            if spec.get("bf16_noise"):
                noise = _dist_judge(runs["bf16"], ref)
                noise["ok_at_the_bars"] = noise.pop("ok")
            del runs
        gc.collect()
        torch.cuda.empty_cache()
        args = SimpleNamespace(device="cuda", dist_url=None,
                               dist_backend="gloo", no_set_device_rank=True,
                               model_parallel=n_model)
        init_distributed(args)
        got = _dist_step_runs(name, b, {**cfg, "world_size": 1, "rank": 0},
                              [("tp", False, slice(0, b))],
                              checkpointed=True, precision=prec)["tp"]
    peaks = all_gather_object(got[2]["step_peak_mem_gb"])
    params = all_gather_object(got[2]["param_gb"])
    launches = all_gather_object(got[2]["launches_first_step"])
    res = {"model": name, "batch": b, "precision": prec,
           "trunk_layers": spec.get("trunk_layers", "full"),
           "backend": dist.get_backend(), "world_size": dist.get_world_size(),
           "model_parallel": n_model, "peak_mem_gb_by_rank": peaks,
           "param_gb_by_rank": params, "launches_by_rank": launches}
    if rank == 0:
        ref = (ref[0], {k: v.cuda() for k, v in ref[1].items()}, ref[2])
        res.update(_dist_judge(got, ref))
        res["one_process_peak_mem_gb"] = ref[2]["step_peak_mem_gb"]
        res["one_process_param_gb"] = ref[2]["param_gb"]
        res["one_process_launches"] = ref[2]["launches_first_step"]
        res["peak_mem_ratio_by_rank"] = [
            p / res["one_process_peak_mem_gb"] for p in peaks]
        res["param_share_by_rank"] = [
            p / res["one_process_param_gb"] for p in params]
        res["launches_equal_one_process"] = all(
            r == res["one_process_launches"] for r in launches)
        res["ok"] = res["ok"] and res["launches_equal_one_process"]
        if noise is not None:
            res["bf16_one_process_vs_this"] = noise
    dist.barrier()
    res["seconds"] = time.perf_counter() - t0
    return res


# (b)'s flags beside the scar flags: two ranks of one card over gloo
TP_FLAGS = ("--model-parallel", str(TP_N), "--dist-backend", "gloo",
            "--no-set-device-rank")


def _tp_scar_judge(free: dict, tp: dict, steps: int) -> dict:
    """(b): the scar CLI at --model-parallel 2 (``tp``, ``_dist_cli``'s
    record) against the launcher-free run on the same rows (``free``):
    each step's loss within 1e-2 relative, both finite, each rank's
    launches equal to the launcher-free run's and at least the plain
    step's per step."""
    per_step = _paths()["b32"]["per_step"]
    rel = [abs(a - b) / abs(b) for a, b in zip(tp["losses"], free["losses"])]
    b = {"free": free, "tp": tp, "steps": len(tp["losses"]),
         "loss_rel_err_max": max(rel) if rel else None,
         # the run's launches (the steps, then the end-of-epoch eval on
         # the train rows) over its steps, each rank's
         "launches_per_step_per_rank": [
             {k: v / len(tp["losses"]) for k, v in r.items()}
             for r in tp["launches_by_rank"]]}
    b["ok"] = (len(tp["losses"]) == len(free["losses"]) == steps
               and tp["distributed"] and tp["backend"] == "gloo"
               and all(math.isfinite(v) for v in tp["losses"] + free["losses"])
               and b["loss_rel_err_max"] <= 1e-2
               and all(r == free["launches"] for r in tp["launches_by_rank"])
               and all(free["launches"][k] >= steps * v
                       for k, v in per_step.items()))
    return b


def _rank_heads(model_name: str, size: int) -> dict:
    """Each tower's head counts by rank at --model-parallel ``size``
    (its first split block's, a meta build: uneven whole heads where
    ``size`` does not divide them)."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.parallel.sharding import shard_tensor_parallel

    out = {}
    for r in range(size):
        model = create_model(model_name, device="meta", skip_init=True)
        shard_tensor_parallel(model, size=size, rank=r)
        for tower in ("visual", "text"):
            blk = next(m for m in getattr(model, tower).modules()
                       if hasattr(m, "local_heads"))
            out.setdefault(tower, []).append(blk.local_heads)
    return out


def phase_tp(card: str, tmp: str) -> dict:
    """Phase 25 (c) (module doc), behind --tp-only: the CLIPA ViT-H-14
    step on two gloo ranks at --model-parallel 2, and the
    ViT-B-16-plus-240 step on TP_UNEVEN_N ranks (uneven whole heads),
    each against the one-process step. Returns their launches."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the workers are other processes
    d = os.path.join(tmp, "tp")
    os.makedirs(d)
    c, = _run_dist(d, "tp_clipa", [["tp_step", {
        "model": "ViT-H-14-CL32-GAP", "batch": CLIPA_PATH_BATCH}]], TP_N)
    u, = _run_dist(d, "tp_uneven", [["tp_step", {
        "model": TP_UNEVEN_MODEL, "batch": TRAIN_BATCH,
        "model_parallel": TP_UNEVEN_N}]], TP_UNEVEN_N)
    u["heads_by_rank"] = _rank_heads(TP_UNEVEN_MODEL, TP_UNEVEN_N)
    u["ok"] = (u["ok"] and u["heads_by_rank"] == TP_UNEVEN_HEADS
               and all(r["flash_mha"] > 0 and r["fused_attn_half"] > 0
                       for r in u["launches_by_rank"]))
    w, = _run_dist(d, "tp_swin", [["tp_step", {
        "model": TP_SWIN_MODEL, "batch": TP_SWIN_BATCH, "trunk_layers": 1,
        "model_parallel": TP_SWIN_N}]], TP_SWIN_N)
    w["replicated_blocks"] = _replicated(TP_SWIN_MODEL, TP_SWIN_N)
    w["ok"] = (w["ok"] and w["replicated_blocks"]
               == ["trunk.stage0_block0.attn"])
    result = {"phase": "tp", "card": card,
              "c_clipa_vit_h14_model_parallel_2": c,
              f"c_{TP_UNEVEN_MODEL}_model_parallel_{TP_UNEVEN_N}": u,
              f"c_{TP_SWIN_MODEL}_model_parallel_{TP_SWIN_N}": w,
              "ok": c["ok"] and u["ok"] and w["ok"]}
    _emit(result)
    shutil.rmtree(d, ignore_errors=True)
    if not result["ok"]:
        raise AssertionError(f"tp phase failed its checks: {result}")
    return {"tp_clipa": c["launches_by_rank"][0],
            "tp_uneven": u["launches_by_rank"][0],
            "tp_swin": w["launches_by_rank"][0]}


def _replicated(model_name: str, size: int) -> list:
    """The blocks of ``model_name``'s vision trunk (one block a stage, as
    the tp phase cuts it) that --model-parallel ``size`` replicates whole
    (a meta build)."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.parallel.sharding import replicated_blocks

    with _trunk_layers(model_name, 1):
        model = create_model(model_name, device="meta", skip_init=True)
    return replicated_blocks(model.visual, size)


def _launched_zoo(res: dict) -> bool:
    """Each rank of a tp_step ran #6 forward and backward on its local
    heads (EVA02-L-14's trunk, SO400M's text tower, ViT-H-14's trunk)."""
    return all(r["flash_mha"] > 0 and r["flash_mha_bwd"] > 0
               for r in res["launches_by_rank"])


def split_share(model_name: str) -> dict:
    """The share of ``model_name``'s parameter bytes that one rank holds
    at --model-parallel TP_N (the split leaves' 1 / TP_N and the whole
    rest), reckoned on a meta build: the prediction of a rank's peak
    memory over the one-process peak, for the parameters, gradients and
    AdamW moments (the activations aside)."""
    from xtagclip_tpu_torch.factory import create_model
    from xtagclip_tpu_torch.parallel.sharding import shard_tensor_parallel

    model = create_model(model_name, device="meta", skip_init=True)
    whole = sum(p.numel() for p in model.parameters())
    shard_tensor_parallel(model, size=TP_N, rank=0)
    local = sum(p.numel() for p in model.parameters())
    return {"model": model_name, "params_m": whole / 1e6,
            "rank_share": local / whole}


def phase_tp_zoo(card: str, tmp: str) -> dict:
    """Phase 25 (d) at full depth (module doc), behind --tp-zoo-only:
    EVA02-L-14, ViT-SO400M-14-SigLIP and mt5-xl-ViT-H-14, each one step
    on two gloo ranks at --model-parallel 2 against the one-process step,
    each rank's peak memory beside the one-process peak and beside the
    predicted share (``split_share``). Returns each model's launches."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the workers are other processes
    d = os.path.join(tmp, "tp_zoo")
    os.makedirs(d)
    runs = _run_dist(d, "tp_zoo", [["tp_step", spec]
                                   for _, spec in TP_ZOO_MODELS], TP_N)
    result = {"phase": "tp_zoo", "card": card}
    for (label, spec), res in zip(TP_ZOO_MODELS, runs):
        res["predicted"] = split_share(spec["model"])
        res["ok"] = res["ok"] and (spec.get("precision") == "fp32"
                                   or _launched_zoo(res))
        result[label] = res
    result["ok"] = all(r["ok"] for r in runs)
    _emit(result)
    shutil.rmtree(d, ignore_errors=True)
    if not result["ok"]:
        raise AssertionError(f"tp_zoo phase failed its checks: {result}")
    return {f"tp_zoo_{label}": r["launches_by_rank"][0]
            for (label, _), r in zip(TP_ZOO_MODELS, runs)}


def phase_tp_nccl(card: str, tmp: str) -> dict:
    """--tp-nccl, on four cards: the scar flags under ``torchrun
    --nproc_per_node 4`` at --model-parallel 2, a (2 data x 2 model) mesh
    over NCCL, against ``--nproc_per_node 2`` without it (DDP over the
    same 2 data ranks: the same rows and seeded crops a data rank), each
    step's loss within 1e-2, with both runs' samples/s and each rank's
    launches."""
    d = os.path.join(tmp, "tp_nccl")
    os.makedirs(d)
    rng = np.random.default_rng(26)
    root = os.path.join(d, "scar_train")
    csv_file = _write_scar_split(root, 2 * TP_STEPS * TRAIN_BATCH, rng)

    def scar(name, *extra):
        return _scar_task(root, csv_file, os.path.join(d, "logs"), name,
                          *extra)

    ddp, = _run_dist(d, "ddp2", [scar("ddp2")], 2)
    tp, = _run_dist(d, "tp4", [scar("tp4", "--model-parallel", "2")], 4)
    rel = [abs(a - b) / abs(b) for a, b in zip(tp["losses"], ddp["losses"])]
    res = {"phase": "tp_nccl", "card": card, "ddp_2x1": ddp, "tp_2x2": tp,
           "loss_rel_err_max": max(rel) if rel else None,
           "samples_per_s_ratio": tp["samples_per_s_after_first"]
           / ddp["samples_per_s_after_first"]}
    res["ok"] = (tp["backend"] == ddp["backend"] == "nccl"
                 and tp["world_size"] == 4 and len(tp["losses"]) == TP_STEPS
                 and len(ddp["losses"]) == TP_STEPS
                 and all(math.isfinite(v) for v in tp["losses"])
                 and res["loss_rel_err_max"] <= 1e-2
                 and all(r == tp["launches_by_rank"][0]
                         for r in tp["launches_by_rank"]))
    _emit(res)
    shutil.rmtree(d, ignore_errors=True)
    if not res["ok"]:
        raise AssertionError(f"tp_nccl failed its checks: {res}")
    return {"tp_nccl": tp["launches"]}


def _ptxas_report(built: dict) -> dict:
    """{kernel entry: [registers, spill store bytes, spill load bytes]} from
    nvcc's -Xptxas -v report of one library (its .log beside it)."""
    import re
    from pathlib import Path

    log = built["log"] or Path(built["path"]).with_suffix(".log").read_text()
    out, entry, spills = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = [int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry] = [int(m.group(1)), *(spills or [0, 0])]
            entry, spills = None, None
    return out


def _device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _profile_window(name, fn, card, top: int = 12):
    """Trace ``fn`` with torch.profiler and print where its time went."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = defaultdict(float)
    host = {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue  # a span around kernels (optimizer.step), not a kernel
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] += _device_time_us(evt) / 1e3
        elif evt.device_type == torch.autograd.DeviceType.CPU:
            host[evt.key] = (evt.self_cpu_time_total / 1e3, evt.count)
    kernel_ms = sum(by_kernel.values())
    port_ms = sum(v for k, v in by_kernel.items()
                  if any(p in k for p in PORT_KERNELS))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:10]
    _emit({"phase": "profile", "window": name, "card": card,
           "wall_ms": wall_ms, "device_kernel_ms": kernel_ms,
           "device_busy_share": kernel_ms / wall_ms,
           "port_kernels_ms": port_ms, "other_kernels_ms": kernel_ms - port_ms,
           "top_kernels_ms": {k[:90]: v for k, v in top},
           "host_self_ms_and_calls": {k[:60]: v for k, v in top_host}})


def phase_profile(card, label, model, ptable, serve_one, train_one,
                  n_batches: int = 20, n_steps: int = 5):
    from xtagclip_tpu_torch.serving import precompute_prompt_features

    _profile_window(
        f"{label}: precompute 3x2304 prompts, batch {PRECOMPUTE_BATCH}",
        lambda: precompute_prompt_features(model, ptable, template_id=0,
                                           batch_size=PRECOMPUTE_BATCH),
        card)

    def run_serve():
        for i in range(n_batches):
            serve_one(i)

    _profile_window(f"{label}: serve {n_batches} batches of {SERVE_BATCH}",
                    run_serve, card)

    def run_train():
        for i in range(n_steps):
            train_one(i)

    _profile_window(f"{label}: train {n_steps} steps of {TRAIN_BATCH}",
                    run_train, card)


def _launches(entries, paths) -> None:
    """Each kernel row's launches by path and in all: a partial-mode row
    (``tp``) counts the tp phase's paths, a whole row the others."""
    for e in entries:
        e["launches_by_path"] = {
            k: v.get(e["name"], 0) for k, v in paths.items()
            if k.startswith("tp_") == ("tp" in e)}
        e["launches"] = sum(e["launches_by_path"].values())


def _prefixed(prefix: str, launches: dict) -> dict:
    """A phase's {path: launches} under its phase's name."""
    return {f"{prefix}_{k}": v for k, v in launches.items()}


def main(argv=()) -> int:
    """Run the phases; ``argv`` holds the command-line arguments."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace the trainer's second epoch, CLIPA and "
                         "BiomedCLIP steps, precompute, serve and train "
                         "steps with torch.profiler")
    ap.add_argument("--clipa-batch-probe", action="store_true",
                    help="run only the build and the search for the "
                         "largest CLIPA stage-2 batch that fits")
    ap.add_argument("--coca-only", action="store_true",
                    help="run only the build, the kernel rows and the "
                         "coca_train and coca phases")
    ap.add_argument("--siglip-only", action="store_true",
                    help="run only the build, the kernel rows and the "
                         "siglip and distill phases")
    ap.add_argument("--siglip-batch-probe", action="store_true",
                    help="run only the build and the search for the "
                         "largest ViT-SO400M-14-SigLIP batch that fits")
    ap.add_argument("--zoo-only", action="store_true",
                    help="run only the build, the kernel rows and the zoo "
                         "phase")
    ap.add_argument("--pretrained-only", action="store_true",
                    help="run only the build, the kernel rows and the "
                         "pretrained phase")
    ap.add_argument("--zoo-batch-probe", action="store_true",
                    help="run only the build and the search for the zoo "
                         "trainers' largest batch that fits")
    ap.add_argument("--dist-only", action="store_true",
                    help="run only the build, the kernel rows and the dist "
                         "phase (with the tp phase's scar run), the CLIPA "
                         "model at full depth")
    ap.add_argument("--tp-only", action="store_true",
                    help="run only the build, the kernel rows and the tp "
                         "phase's CLIPA ViT-H-14 step at full depth and "
                         "ViT-B-16-plus-240 step on 4 ranks")
    ap.add_argument("--tp-zoo-only", action="store_true",
                    help="run only the build, the kernel rows and the tp "
                         "phase's EVA02-L-14, ViT-SO400M-14-SigLIP and "
                         "mt5-xl-ViT-H-14 steps at full depth")
    ap.add_argument("--fp16-only", action="store_true",
                    help="run only the build, the kernel rows and the fp16 "
                         "and intermediates phases")
    ap.add_argument("--tp-nccl", action="store_true",
                    help="on four cards: run only the build and the scar "
                         "flags at --model-parallel 2 on a 2 x 2 NCCL mesh "
                         "against DDP on 2 cards")
    ap.add_argument("--dist-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)  # a process of the dist phase
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.dist_worker:
        return dist_worker(args.dist_worker)
    from xtagclip_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    _emit({"phase": "build", "card": card, "seconds": build_s,
           "kernels": {k: v["path"] for k, v in built.items()},
           "ptxas": {k: _ptxas_report(v) for k, v in built.items()}})
    if args.tp_nccl:
        with tempfile.TemporaryDirectory(prefix="xtag_tp4_") as tmp:
            phase_tp_nccl(card, tmp)
        print(card, flush=True)
        return 0
    if args.clipa_batch_probe or args.siglip_batch_probe or \
            args.zoo_batch_probe:
        with tempfile.TemporaryDirectory(prefix="xtag_probe_") as tmp:
            if args.clipa_batch_probe:
                phase_clipa_batch_probe(card, tmp)
            if args.siglip_batch_probe:
                phase_siglip_batch_probe(card, tmp)
            if args.zoo_batch_probe:
                phase_zoo_batch_probe(card, tmp)
        print(card, flush=True)
        return 0

    seconds = {}

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            seconds[name] = time.perf_counter() - t0
            print(json.dumps({"phase_seconds": name,
                              "seconds": seconds[name]}), flush=True)

    entries = timed("kernels", phase_kernels, card)
    entries += timed("tp_kernels", phase_tp_kernels, card)
    block_paths = timed("flash_block", phase_flash_block, card)
    if args.coca_only or args.siglip_only or args.zoo_only or \
            args.pretrained_only or args.dist_only or args.tp_only or \
            args.tp_zoo_only or args.fp16_only:
        with tempfile.TemporaryDirectory(prefix="xtag_part_") as tmp:
            if args.fp16_only:
                ptable = _scar_prompt_table()
                paths = _prefixed("fp16", timed("fp16", phase_fp16, card,
                                                ptable))
                paths.update(_prefixed("intermediates", timed(
                    "intermediates", phase_intermediates, card, ptable)))
            elif args.tp_only:
                paths = timed("tp", phase_tp, card, tmp)
            elif args.tp_zoo_only:
                paths = timed("tp_zoo", phase_tp_zoo, card, tmp)
            elif args.dist_only:
                paths = timed("dist", phase_dist, card, tmp, full_depth=True)
            elif args.coca_only:
                paths = timed("coca_train", phase_coca_train, card, tmp,
                              profile=args.profile)
                paths.update(timed("coca", phase_coca, card,
                                   profile=args.profile))
            elif args.zoo_only:
                paths = timed("zoo", phase_zoo, card, tmp)
            elif args.pretrained_only:
                paths = timed("pretrained", phase_pretrained, card, tmp)
            else:
                paths = timed("siglip", phase_siglip, card, tmp)
                paths.update(timed("distill", phase_distill, card, tmp))
        _emit({"phase": "seconds", "card": card, "build": build_s,
               **seconds})
        paths.update(block_paths)
        _launches(entries, paths)
        _emit({"kernels": entries})
        print(card, flush=True)
        return 0
    timed("flash_poison", phase_flash_poison, card)
    b32, gap = _paths()["b32"], _paths()["gap"]
    with tempfile.TemporaryDirectory(prefix="xtag_smoke_") as tmp:
        paths, model, ptable, serve_one, table = timed(
            "serve", phase_serve_and_path, card, b32)
        paths["decode_serve"] = timed("decode_serve", phase_decode_serve,
                                      card, model, table)
        paths["train"], train_one = timed("train", phase_train, card, ptable,
                                          b32)
        paths["multi_step"] = timed("multi_step", phase_multi_step, card,
                                    ptable)
        timed("train_path", phase_train_path, card, ptable, b32)
        last_tag = os.path.join(tmp, "trainer_last")
        paths["trainer"] = timed("trainer", phase_trainer, card, last_tag,
                                 profile=args.profile)
        paths["predict"] = timed("predict", phase_predict, card, model, table,
                                 last_tag, tmp)
        gap_paths, g_model, _, g_serve_one, g_table = timed(
            "gap_serve", phase_serve_and_path, card, gap)
        paths.update({"gap_" + k: v for k, v in gap_paths.items()})
        paths["gap_train"], g_train_one = timed("gap_train", phase_train,
                                                card, ptable, gap)
        timed("gap_train_path", phase_train_path, card, ptable, gap)
        paths.update(_prefixed("fp16", timed("fp16", phase_fp16, card,
                                             ptable)))
        paths.update(_prefixed("intermediates", timed(
            "intermediates", phase_intermediates, card, ptable)))
        paths["gap_trainer"] = timed("gap_trainer", phase_gap_trainer, card)
        paths["gap_predict"] = timed("gap_predict", phase_gap_predict, card,
                                     g_model, g_table, tmp)
        with _env(XTAGCLIP_EXTRA_CONFIGS=_depth_cut_configs(tmp)):
            paths.update(timed("clipa", phase_clipa, card, tmp,
                               profile=args.profile))
            paths["clipa_336_eval"] = timed("clipa_eval", phase_clipa_eval,
                                            card, tmp)
            timed("clipa_path", phase_clipa_path, card)
        timed("rn50", phase_rn50, card)
        paths["biomedclip_scar"] = timed("biomedclip_scar",
                                         phase_biomedclip_scar, card, tmp,
                                         profile=args.profile)
        paths["baselines"] = timed("baselines", phase_baselines, card, tmp,
                                   os.path.join(tmp, "biomedclip.pt"))
        paths.update(timed("coca", phase_coca, card, profile=args.profile))
        paths.update(timed("coca_train", phase_coca_train, card, tmp,
                           profile=args.profile))
        paths.update(timed("siglip", phase_siglip, card, tmp))
        paths.update(timed("distill", phase_distill, card, tmp))
        paths.update(timed("zoo", phase_zoo, card, tmp))
        paths.update(timed("pretrained", phase_pretrained, card, tmp))
        paths.update(timed("dist", phase_dist, card, tmp))
    if args.profile:
        phase_profile(card, b32["label"], model, ptable, serve_one,
                      train_one)
        phase_profile(card, gap["label"], g_model, ptable, g_serve_one,
                      g_train_one)
    _emit({"phase": "seconds", "card": card, "build": build_s, **seconds,
           "total": time.perf_counter() - t0})
    paths.update(block_paths)
    _launches(entries, paths)
    _emit({"kernels": entries})
    print(card, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
