"""Drive the PyTorch port's paths once on an NVIDIA GPU: the batched ABC
decode paths (the plain decode path, speculative decoding, the
attn_impl="pallas" decode path, the lean int8 / int4 decode-attention probe
path, fp32 models, the continuous-batching server and the sampling CLI),
the training path (the train step, cli/train.py, cli/train_bench.py),
TunesFormer inference and serving (the model, the bar generator, the
server and its HTTP front end, the CLIs), TunesFormer training (the
train step, curation, cli/tunesformer_train.py, the MFU probe), ABC ->
WAV (the synth, the eval pipeline and its CLI), the Audiobox scorer
(the WavLM encoder, the predictor, cli/audio_aes.py), the
Mixture-of-Experts GPT (the model, training, decode, serving, sampling),
the parallel paths at world size 1 (the sharded trainer, the sharded
servers and render, the pipeline and sequence steps), GPT-2 import
(``init_from=gpt2*``: sampling, evaluation and fine-tuning at GPT-2 124M's
width), the golden-replay harness, the transfer experiment and the host
entry points (the Bach pipeline, MIDI <-> text, the 4-part builder,
MusicXML -> ABC, the random baselines, the project shell), the
trained-model decode studies, the multi-process smoke and the last
experiment scripts (the window and refresh contracts, the MFU
decomposition, the fuzz campaign, the int4 storage probes).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero without
printing a result):

1. environment: the card (name and power limit from nvidia-smi), torch,
   CUDA, nvcc, ninja, triton; TF32 off for every fp32 product;
2. build: the CUDA kernels, compiled from ``ai_music_generation_tpu_torch/
   ops/csrc`` (nvcc's register/shared-memory report is printed);
3. kernel vs plain twin at the batched decode shape (B=4096, S=128, H=6,
   KH=2, D=64, int8 cache) with the lockstep and the ring mask, pos in
   {0, 127}, plus a 3-row batch at KH=2 and at MHA (KH=6) in all four
   modes (int8/bf16 cache x lockstep/ring mask) at pos in {0, 7, 8, 127},
   and
   3 rows over a 1024-column cache (GPTConfig's default block_size) at MHA
   with a bf16 cache and at KH=2 with an int8 one: caches and scales
   bit-exact, the output within one bf16 ulp of its range of the twin
   evaluated in fp32; then both timed on the card;
4. model: the bench-config GPT (6 layers, 6 heads, 384 wide, block 256,
   vocab 128, KH=2, int8 cache) on the card against the same weights on the
   CPU: prefill plus 16 decode steps, logits compared for 8 rows;
5. main path: ``Generator(window=128, max_new_tokens=500, temperature=0.8,
   top_k=200)`` at batch 4096 with 8-token prompts: shape, prompts kept,
   token range, same-seed determinism, and exactly n_layer * 500 kernel
   launches per generate; then decode throughput timed with CUDA events;
6. spec kernel vs twin: the verify-attention kernel with its slab write
   (K2, ``spec_attention_update``) and without (K3, ``spec_attention``) at
   B=4096 and B=3, S=256, H=6, D=64, T in {1, 5, 7, 128} (at B=3 also the
   regime edges 8, 16, 17, 64, 65, and an added fourth row that reads
   nothing: output 0), and at B=3 (+ the dead row) over S=1024, where a
   refresh runs 16-query tiles, T in {5, 17, 64, 65, 128}; cursor in
   {0, 8, S-Tw}, int8 and bf16 caches and int8_dots:
   the write bit-exact, the output within one bf16 ulp of its range of the
   twin evaluated in fp32 (2^-6 with int8_dots); then both timed at T=5 (a
   verify step) and T=128
   (a refresh), K3 also with a bf16 cache beside the one PyTorch call that
   computes it (``scaled_dot_product_attention`` under the col_pos mask);
7. spec model: the ``SPEC`` GPT (the bench config with MHA, which the spec
   cache needs) on the card against the CPU: a prefill, 4 verify steps
   with scripted rejections, a refresh; logits compared for 8 rows;
8. spec main path: ``SpecGenerator(max_new_tokens=500, temperature=0.8,
   top_k=200, n_draft=4)`` at batch 4096 with 8-token prompts, twice with
   one seed: shape, prompts kept, token range, identical runs, the n_steps
   bounds, and exactly n_layer kernel launches per model call (prefill,
   verify steps, refreshes, counted by a hook on the model); then a run
   with ragged 8-64-token prompts and a greedy run;
9. throughput: spec tokens/s and committed tokens per step beside the plain
   ``Generator`` on the same ``SPEC`` model (window 256, K1 at MHA), timed
   with CUDA events. Printed, not gated;
10. prefix kernel vs twin: the valid-prefix decode attention (K4,
    ``decode_attention``) at B=4096 and B=3, S=256, H=6, D=64, bf16,
    lengths {1, 63, 64, 100, 255, 256}, NaN past the length: finite and
    within one bf16 ulp of its range of the twin evaluated in fp32; then
    kernel, twin and ``scaled_dot_product_attention`` on the prefix timed
    at lengths 128 and 256;
11. pallas model: the ``PALLAS`` GPT (the bench widths with MHA, a bf16
    cache, ``attn_impl="pallas"``) on the card against the CPU: prefill plus
    16 decode steps, logits compared for 8 rows;
12. pallas main path: ``Generator(max_new_tokens=500, temperature=0.8,
    top_k=200)`` at its default window 256, batch 4096, 8-token prompts,
    twice with one seed: shape, prompts kept, token range, identical runs,
    exactly n_layer * 500 = 3000 K4 launches and no K1 launch per generate;
    then tokens/s and peak memory beside the same weights with
    ``attn_impl="xla"`` (K1). Printed, not gated;
13. int8 prefix kernels vs twin: K5 (``decode_attention_int8``) and K6
    (``decode_attention_int8_multirow``, R in {1, 8}) at B=4096 and B=16,
    S=256, lengths {1, 127, 128, 200, 256}, int8 127 and scales 1e4 past
    the length: the yardstick of phase 10; then timed at length 256;
14. lean kernel vs twin: the lean T=1 attention (K7, ``lean_attention``)
    in both modes (lean8: int8 cache, requantized q and probabilities;
    lean4: position-packed int4 cache) at B=4096 and B=3, S=256 and S=16:
    finite and within 2^-6 of its range of the twin (one p8 or
    bf16-probability rounding flip); then kernel and twin timed at B=4096,
    S=256;
15. probe path: ``experiments/int4_kernel_probe.py::run_variant`` at full
    width (B=4096, S=256, 6 layers) for xla8, lean8 and lean4: exactly 6
    K7 launches per lean step (none for xla8), a finite final q; one lean8
    and one lean4 step on a 3-row slice of the same caches against the
    twin, layer by layer, within the phase-14 yardstick; ms per layer-read
    beside each variant's byte floor, printed, not gated;
16. fp32 kernels vs twin: K1's fp32 instantiation (fp32 q and slabs over
    an int8 or fp32 cache) at B=4096, S=128 and 3 rows over S=1024, KH 2
    and 6, lockstep and ring, pos {0, S-1} (3 rows also 7); the fp32
    verify kernel
    (K2, the tensor-core kernel of ``csrc/spec_attention_mma.cuh`` with
    split passes) at B=4096 and B=3 (+ a dead row), S=256, T in {1, 5,
    128}, and B=3 (+ the dead row) over S=1024, T in {5, 17, 64, 65, 128},
    int8 and fp32 caches, full fp32 operands: caches, scales and writes
    bit-exact, the output within FP32_KERNEL_FRAC of its range of the twin
    on the card; then fp32 K1, fp32 K2 (verify, refresh, and the sampling
    CLI's B=64 verify), fp32 K3 (beside fp32
    ``scaled_dot_product_attention`` over an fp32 cache) and K1's ring
    mode at the serving tick's B=8192 timed beside their twins;
17. fp32 models: the bench widths at fp32 (flat_kv KH=2 int8, MHA with an
    fp32 cache, spec MHA int8) on the card against the CPU, logits within
    FP32_MODEL_FRAC of their range (FP32_INT8_MODEL_FRAC over an int8
    cache); a greedy fp32 Generator at B=64, 100
    new tokens: exactly n_layer K1 launches a step, no twin call;
18. serving model: the bench model in ring mode (cache_len 128, 8192
    slots) against the CPU for 8 rows at staggered prompt lengths,
    admitted by the engine's insert-prefill (roll, scatter), 144
    teacher-forced ticks with two window refreshes (the cursor wraps):
    logits within 2^-4 of their range, n_layer K1 launches a tick;
19. serving main path: ``GenerationServer`` at docs/SERVING.md's headline
    (8192 slots, cache_len 128, admit_group 512, 64 ticks a call) under
    cli/serve_bench.py's load (16,384 requests, prompts 4-48 tokens,
    128-256 new tokens, T 0.8, top_k 64), a cold then a hot pass: every
    request finishes with its budget, tokens in range, K1 launches =
    n_layer x ticks, a request re-run alone in slot 0 and in another slot
    identical (its hot-pass tokens compared, printed), the counter noise
    bit-equal card vs CPU; tok/s, latency and phases printed;
    then cli/serve.py's HTTP server on 127.0.0.1 (/generate, SSE,
    /health);
20. sampling CLI: ``cli/sample.py``'s main over a ckpt.pt of init weights
    (bench widths, the corpus's vocabulary) and the real-path corpus
    (random ABC tunes, irishman char): 1,000 samples at batch 1,000, 500
    new tokens, T 0.8, top_k 200, --kv_quantized --flat_kv, twice at one
    seed (identical files), at --dtype=float32, and --speculative over an
    MHA checkpoint at fp32 (64 samples): file names, X: headers;
    samples/s and tok/s printed;
21. train step: the music config (configs/irishman_char.py's widths, the
    corpus's vocabulary) on the card against the CPU from the same init
    weights and batch (accum 2 x batch 4, lr 1e-3): loss and grad_norm
    within 1e-4 of their value and the parameters within 1e-4 of their
    range at fp32, 2^-6 at bf16; at dropout 0.2 the masks of layer 0 at its
    four sites bit-equal card vs CPU and an fp32 step within 1e-4; then
    the dropout kernel (``ops/dropout.py``) against its plain twin, forward
    and backward bit-equal: the music step's four sites at batch 8 (twin on
    the CPU, bf16 and fp32) and 64 (phase 22's shapes; twin on the card,
    bf16), phase 30's eight TunesFormer sites (twin on the card, bf16); and
    timed at the attention probabilities of batch 64 ([64, 6, 256, 256],
    bf16) beside the twin and its bound;
22. train CLI: ``cli/train.py configs/irishman_char.py`` (batch 64, block
    256, dropout 0.2, bf16) on phase 20's corpus for 30 iterations, an
    eval every 10 (5 batches): the val loss falls, ckpt.pt and
    last_iter_ckpt.pt exist, ``--init_from=resume`` continues from the
    checkpoint's iteration with its model_args to 40; ms/iter and MFU
    printed; then ``cli/sample.py`` samples 64 tunes from its ckpt.pt
    (200 new tokens), each file with its X: header;
23. train bench: ``cli/train_bench.py`` at GPT-2 124M (12 layers, 12
    heads, 768 wide, block 1024, batch 12, vocab 50304, bf16), 3 burn-in
    and 10 timed steps, without and with remat, then with
    ``--attn_impl=flash``: ms/iter, MFU against 989 TFLOP/s, peak memory
    printed. Phases 21-23 launch none of K1-K7 (their
    counts are set to 0 before each and read after; any launch fails the
    run), and their dropout goes through the dropout kernel. ``--profile
    train`` profiles one 124M step and one step at the music widths;
24. K1 at the TunesFormer shapes (MHA H = KH = 12, D = 64, bf16 cache) and
    every batch phases 26-28 give it: the char core (S=32, lockstep, pos 0,
    1, 31) and the patch core (S=128, lockstep, pos 0, 5, 127) at B 1, 3,
    8, 16, 64 and 1024, the server's patch core (S=128, ring, random
    lengths with 0 and 127) at B 3, 64 and 1024, each lockstep column
    written twice (the generator's rewound first bar): caches bit-exact,
    the output within one bf16 ulp of its range of the twin in fp32 (after
    phase 28 the script fails if a tunes path ran K1 at a (B, S, mode) not
    checked here); then kernel, twin and ``scaled_dot_product_attention``
    (attention only: no column write) timed at B=1024: the char step
    (S=32), the generator's patch step (S=128) and the server's ring patch
    step (S=128);
25. TunesFormer: the reference model (``TunesFormerConfig()``: 9+3 layers,
    768 wide, 12 heads) on the card against the same init weights on the
    CPU, bf16 and fp32: a cached prefill of the serve-bench prompt, 3 patch
    steps and a teacher-forced 32-position char scan within 2^-4 (bf16) and
    1e-4 (fp32) of the range, also against the full forwards on the card;
    exactly 9 K1 launches a patch step and 3 a char step;
26. generator: ``TunesGenerator`` (top_p 0.8, top_k 8, T 1.2) at batch 16,
    32 patches, the serve-bench prompt, twice at one seed: identical texts
    that keep the prompt, 105 K1 launches a bar and no call of the twin;
    tunes/min; then batch 1,024, printed;
27. server: ``TunesServer`` at 1,024 slots under cli/serve_bench.py's tunes
    load (1,024 requests, 32 patches), a cold then a hot pass: every
    request finishes with its prompt, 105 K1 launches a bar, no twin call,
    a request re-run alone in slot 0 and alone in slot 1 (a filler
    admitted a bar before it) identical, the counter
    noise bit-equal card vs CPU; tunes/min, latency and peak memory
    printed; then cli/serve_tunesformer.py's HTTP server on 127.0.0.1;
28. CLIs: a weights.pth of init weights written by
    ``save_reference_checkpoint`` and read back bit-equal, then
    cli/tunesformer_generate.py (8 tunes) and cli/sample_tunesformer.py (8
    leadsheets) on it: file names, X: headers, 105 K1 launches a bar.
    ``--profile tunes,tunes_serve`` profiles phase 26's generate and one hot
    pass of phase 27's load;
29. TunesFormer train step (train/tunes_step.py: optax_adamw, the HF cosine
    schedule, the NaN guard) at the reference widths cut to 2+1 layers,
    batch 2, on the card against the CPU from one init, at lr 1e-3 (an
    update moves a parameter ~1e-3, ten times the fp32 yardstick): 3 steps
    at fp32 (parameters within 1e-4 of their range, each Adam moment of
    its range, losses of their value) and bf16 (2^-6), two fp32 steps at
    dropout 0.1, each core's layer-0 masks
    (under its own key) bit-equal card vs CPU, and a NaN parameter's step
    leaving every parameter, moment and the count bit for bit;
30. TunesFormer's real path: 500 random_tunes as .abc files,
    cli/add_control_codes.py -> data.json, cli/tunesformer_train.py at
    its defaults (the reference config: 9+3 layers, 768 wide, 128 x 32,
    batch 8, bf16, dropout 0.1) for 2 epochs (the eval loss falls,
    weights.pth and logs.txt written) and ``--load_from_checkpoint`` to 3
    (epoch 3 alone); ms/iter (median of the steady epochs' steps) and peak
    memory printed; then cli/sample_tunesformer.py over the trained
    weights.pth and 4 curated tunes: 105 K1 launches a bar, no twin call;
31. experiments/tunes_mfu.py at batches 8 and 32 (the reference widths,
    dropout 0, bf16): ms/iter, TFLOP/step by FlopCounterMode (equal to the
    analytic count), MFU against 989 TFLOP/s, peak memory. Phases 29-31
    train with none of K1-K7 (their counts are set to 0 before each and
    read after; any launch fails the run); phases 29 and 30 drop (0.1)
    through the dropout kernel, phase 31 does not (its launches are set to
    0 before each, read after and printed; a count that breaks this fails
    the run). ``--profile tunes_train`` profiles one train step at phase
    30's configuration;
32. synth: ``synth/render.py::render_events_batch`` at the pipeline's
    synth_batch (8) and full length (120 s at 16 kHz) on the card against
    the port on the CPU, for the sample bank, the additive voice and an
    sf2 font with two velocity layers written by ``write_sf2``, on a batch
    of the protocol corpus and on a crafted batch (overlapping notes, a
    start past the end, a pitch halfway between two bank roots): each wave
    within 1e-5 of its range, trim indices and ``synthesize_midi_batch``'s
    output lengths equal, two card runs bit-equal;
33. ABC -> WAV: cli/abc_to_midi_wav_and_aesthetics.py through ``main`` on
    the card on the JAX package's recipe (128 random ABC tunes of its
    protocol's 1,000, for the script's time limit; the proxy scorer):
    n_failed 0, a MIDI, a WAV, an aesthetics row (finite) and a similarity
    row for every tune, 8 WAVs within 1 LSB of the CPU's
    render; tunes/min of the whole run and each stage's seconds (ABC ->
    MIDI, render, trim and write, metrics, scoring), then the render alone
    at synth_batch 8 and 64 with its peak memory. Phases 32-33 launch none
    of K1-K7 (their counts are set to 0 before each and read after; any
    launch fails the run). ``--profile synth`` profiles one render batch;
34. the Audiobox model: ``AudioboxConfig()`` (WavLM base, fp32) from a
    seeded init, saved as a checkpoint with a weight-norm positional conv
    and read back (``load_torch_checkpoint``, ``config_from_state_dict``,
    the loader: every key placed, the config equal); four 10-s chunks
    (noise, a rendered tune, ragged at 3.7 s, nearly silent) on the card
    against the CPU: every hidden state and the scores within 1e-4 of their
    range, also under PyTorch's default TF32 flags with float32 matmuls at
    "high" (the predictor pins IEEE fp32 itself); the card's bucket table
    at T=499 the CPU's; a file alone scoring as in a crowd; then the
    forward (CUDA events) and ``score_waves`` (host to host) at batch 8 and
    10, peak memory, FLOPs a chunk (``FlopCounterMode``) and their share
    of 67 TFLOP/s;
35. cli/audio_aes.py (``--ckpt`` = phase 34's file, ``--batch-size 10``)
    over phase 33's 128 WAVs and a missing path: 129 rows, the missing
    one NaN; files/min and chunks/s; then EvalPipeline through
    cli/abc_to_midi_wav_and_aesthetics.py on 32 of phase 33's tunes with
    ``$AUDIOBOX_WEIGHTS`` set: engine ``audio-aes``, rows within 1e-5 of
    the CLI's. Phases 34-35 launch none of K1-K7. ``--profile audiobox``
    profiles one forward at batch 10;
36. MoE: K1 vs twin at every shape the MoE paths give it (the trained
    model's decode, B=256, and sampling, B=64: S=256, MHA, bf16 cache; the
    bench config's decode, B=4096, S=128, KH=2, int8; its serving tick,
    B=8192, ring), then timed at the decode step beside SDPA; the MoE
    protocol's model (6L/6H/384, block 256, vocab 128, 4 experts, top 2,
    capacity 1.25) on the card against the CPU over 8 x 256 tokens: the
    card's routing equal to ``route`` on its own probabilities, a token
    routed otherwise only where its ranked probabilities lie within twice
    their card-vs-CPU difference (counted); fp32 routing equal but for
    near-ties (ranked probabilities within 1e-6, counted), logits within
    FP32_MODEL_FRAC of the range, bf16 within 2^-4; the same under PyTorch's default TF32 flags; with float32
    matmuls at "high" the pinned router within 1e-5 of the CPU's
    probabilities (an unpinned one printed);
37. MoE training: ``cli/train.py`` at the protocol (experiments/
    moe_probe.py's corpus; batch 64, lr 1e-3, bf16) for 150 iterations:
    the val loss falls, model_args carries the MoE keys, a resume to 200
    with the dense flags keeps the MoE architecture; ms/iter; then the
    dense and the MoE train step timed (CUDA events), their ratio beside
    the FLOP ratio, peak memory. No kernel of the port runs;
38. MoE decode: the trained model at B=256, 200 new tokens (two same-seed
    generates bit-equal, 1200 K1 launches a generate), and the bench
    config with 4 experts at the bench protocol (3000 K1 launches a
    generate): tok/s, peak memory;
39. MoE serving: ``GenerationServer`` over the bench config with 4 experts
    at 8192 slots, cache_len 128, 8,192 requests after a cold pass: every
    request finishes with its budget, K1 ring launches = n_layer x ticks;
    tok/s, latency p50/p95/p99, peak memory;
40. MoE sampling: cli/sample.py over the trained ckpt.pt, 64 samples, 1206
    K1 launches. Every MoE path's K1 shapes must be among phase 36's;
41. the sharded trainer (``parallel/``) on the card over NCCL at world
    size 1 (a process group of one joined in this process on localhost):
    the music config at full width on phase 20's corpus with ``fsdp=True``
    (FSDP2 over the data axis) and the tensor-parallel plan over a model
    axis of 1, MESH_ITERS iterations of the trainer's step whose losses
    equal the plain ``Trainer``'s at the same seed within MESH_LOSS_FRAC of
    their value; its checkpoint resumed with ``fsdp=False`` restores the
    parameters and AdamW moments bit for bit and gives the plain trainer's
    next loss; then the 4-expert MoE protocol of phase 37 with expert
    parallelism over the model axis, against the plain MoE trainer. ms/iter
    of both trainers (CUDA events, the median after 5 warm-up
    iterations); no kernel of the port runs;
42. the rest of the parallel paths in a group of one over NCCL (as phase
    41): ``GenerationServer`` over ``make_mesh(1, 1)`` (serve/mesh.py's
    control plane, the model's mesh parts, the token gather) at phase 19's
    configuration under its cold and hot passes, every request's tokens
    equal to the unsharded server's on the same weights, K1 launched on
    that path (``by_path["serve_mesh"]`` of K1's entry), tok/s of both
    over a hot pass of MESH_SERVE_REQUESTS each (sharded, then plain);
    ``TunesServer`` over it (the reference model at phase 27's 1,024
    slots, its cold pass, then a pass of 1,024 more each), texts equal to
    the unsharded server's;
    the render of
    phase 32's tunes over it bit-equal to the unsharded render; the
    pipeline (one stage, 4 microbatches) and sequence (one chunk, the ring
    attention) train steps on the music config (dropout 0, batch 16 x 256,
    optax_adamw at 1e-3) against the plain step on the same batches, each
    of 6 losses within MESH_LOSS_FRAC of its value, ms/step printed. The
    render and the steps launch none of K1-K7;
43. GPT-2 import: K1 at GPT-2 124M's decode step (B=256, S=1024, MHA
    H = KH = 12, D = 64, bf16 cache, lockstep) against the twin at pos 0,
    128, 507 and 1023 (the yardstick of phase 3), then timed beside SDPA;
    a random-init GPT-2 124M (vocab 50257, 1024 positions) written from a
    seed as a HF directory (``gpt2-random/``: config.json and
    model.safetensors with the hub file's names, Conv1D layout and mask
    buffers) and loaded through ``cli/sample.py::load_model(init_from=
    "gpt2-random")`` on the card (bf16) and on the CPU (fp32): a prefill
    and 16 decode steps at B=256 vs 4 CPU rows within 2^-4 of the range;
    ``Generator`` (T 0.8, top_k 200, window 1024) at 256 prompts of 8
    tokens, 500 new tokens, twice at one seed: tokens in range, identical
    runs, exactly 12 x 500 = 6,000 K1 launches a generate (the prefill
    runs none; positions 8..507 are one T=1 step each), every K1 shape of
    the path one checked and timed here; tok/s of a third generate; then
    ``cli/train.py configs/eval_gpt2.py --init_from=gpt2-random
    --eval_iters=20`` and ``cli/train.py configs/finetune_shakespeare.py
    --init_from=gpt2-random`` for 5 iterations (accum 2 x 1 x 1024, bf16)
    on 2M random ids: every loss finite, the iter-0 loss within 2^-6 of
    the CPU's fp32 loss on the trainer's first batch, no launch of K1-K7;
    ``utils/sizing.print_report`` for GPT-2 124M at the card's peak;
44. the replay harness: ``cli/replay_goldens.py --device cuda`` over
    fixtures made from a seed (IrishMAN-style JSON, Bach-style midi-text
    directories, the reference TunesFormer's weights.pth written by the
    port's exporter, phase 34's seeded Audiobox checkpoint and 4 WAVs, a
    byte-level BPE trained by ``tokenizers`` as encoder.json/vocab.bpe with
    an input.txt) with goldens counted from their recipes: every stage
    with inputs PASSes, audio-aes parity, abc2midi and fluidsynth SKIP
    unless their binaries are present, exit 0; no launch of K1-K7;
45. the last host entry points: ``cli/transfer_experiment.py`` at its
    defaults but its iterations with ``--device=cuda`` in a temporary
    directory (400 melodies and 120 chorales synthesized, converted to
    midi-text, split and prepared with the union vocab; three legs through
    ``cli/train.py``: 300 iterations on the melodies, a resume into the
    chorales to 500, 200 from scratch on the chorales; 4L/4H/256d, block
    256, batch 32, bf16):
    each leg ends at its iteration, the transfer leg's evals start at 300,
    every val loss finite, no launch of K1-K7; the losses, the verdict
    (recorded, not gated) and ms/iter per leg printed; then each host CLI
    once on seeded fixtures (``bach_pipeline``'s six subcommands,
    ``midi_to_text --processes=2`` and ``text_to_midi``,
    ``build_synthetic_4parts``, ``batch_convert_xml --processes=2``,
    ``random_baselines`` in its four modes, ``python -m
    ai_music_generation_tpu_torch run`` as a subprocess), every output
    present and non-empty in its expected count;
46. the trained-model decode studies (``experiments/{realpath_bench_r5,
    realpath_window_r5,window64_probe,int8_quality,gqa_quality,
    spec_decode,spec_trace,serve_soak}.py``) at full width (the bench
    widths, 3,000 tunes, 500 new tokens, the 1,000-sample CLI leg), their
    three trainings cut to STUDY_ITERS iterations, one timed generate a
    leg at STUDY_BATCH rows (spec_trace's at B=4096), spec_trace
    unprofiled, the soak at STUDY_WAVES
    waves: every val loss falls, every teacher NLL is finite, every plain
    generate, CLI run and soak wave launches exactly n_layer K1 a T=1 step
    and no K2, every speculative generate K2 and no K1 (spec_trace's
    int8_dots variant included), the soak's accounting holds; each study's
    JSON line printed. Then K2's int8_dots mode (the integer tensor-core
    mode) against its twin at spec_trace's verify step (B=4096, S=256,
    T=8), with a bf16 q and with an fp32 one, and timed beside K2's
    bf16-dot int8 mode on the same inputs, then the same over 120 live
    history columns and at a refresh, and
    ``parallel/worker_smoke.py`` over NCCL at world size 1.
47. the last experiment scripts (``experiments/{window_quality,
    refresh_quality,window_flat_probe,mfu_sweep,fuzz_campaign,int4_probe,
    int4_probe2,int4_cache_probe}.py``) in phase 46's work directory
    (window_quality reuses its spec checkpoint) at full width: trainings
    cut to STUDY_ITERS, one timed generate a leg at STUDY_BATCH rows,
    mfu_sweep at
    both models with every variant, the fuzz campaign at FUZZ_CASES, the
    int4 probes at their full shapes (B=4096, S=256): every val loss falls,
    every NLL is finite, every generate launches exactly n_layer K1 a T=1
    step and no other kernel, mfu_sweep none of K1-K7 with finite losses,
    MFU in (0, 1) and a big batch run, the campaign clean, the int8 and
    packed probe variants timed and no sum pass above SUM_RATE_LIMIT; each
    module's JSON line printed.

The last two lines are a JSON summary of each kernel and
``{"ok": true, "device": {...}}``. Each kernel's ``launches`` counts its
launches in its path's main-path run (phases 5, 8, 12, 15, 19, 20, 22,
26, 27, 28, 30, 37-47;
every count is set to 0 just before each of them and read just after); a
kernel with no caller on any path (K3, K5, K6) shows its count summed over
those runs up to phase 30 (phases 37-40 are asserted to launch K1 alone),
and its kernel-vs-twin launches as ``check_launches``.
K1's entry carries its ring mode (``ring``: phase 19's launches, the
B=8192 timing) and its fp32 mode (``fp32``: phase 20's fp32 run), K2's its
fp32 mode (``fp32``: phase 20's fp32 speculative run, with the refresh and
the CLI's B=64 shape), K3's its fp32 mode (``fp32``), each with its own
numbers. K1 at the TunesFormer shapes has an entry a mode:
``gqa_decode_update/tunes_char`` (lockstep S=32, every char step),
``gqa_decode_update/tunes_patch`` (lockstep S=128, the generators' patch
steps) and ``gqa_decode_update/tunes_ring`` (ring S=128, the server's patch
step), each timed at B=1024 with its launches on phases 26-28 and 30's
sampling (counted by
mode by a wrapper on the models' K1 call, their sum checked against K1's
own count) and the batches it ran at; their ``library_ms`` is SDPA's
attention alone, which writes no column. ``gqa_decode_update/moe`` is K1 on
the MoE paths (phases 38-40): timed at the trained model's decode step,
its launches those of the lockstep paths, ``ring_launches`` the serving
path's, ``by_path`` each path's and ``shapes`` the shapes they ran at.
K1's own entry's ``by_path["serve_mesh"]`` is its launches on phase 42's
sharded server, ``by_path["gpt2"]`` its launches a GPT-2 generate (phase
43); ``gqa_decode_update/gpt2`` is K1 at that path's shape, timed in phase
43, with those launches and the shapes the path ran at.
``by_path["studies"]`` of K1's and of K2's entry is their launches in
phase 46, ``by_path["experiments"]`` of K1's its launches in phase 47;
K2's ``int8_dots`` holds that mode's numbers at spec_trace's verify step
(with its source, its fp32-q time and the bf16-dot mode's time on the
same inputs, the same two over a shorter history and at a refresh), its
launches in spec_trace's timed generate and the generate's ms a verify
step.
``bound_ms`` is the least time the card could take for the timed call: its
bytes (each input read once, each output written once) over 3.35 TB/s or
its operations over 989 TFLOP/s (1979 TOP/s for int8 x int8 products; the
fp32 K1's over 67 TFLOP/s, its CUDA cores; the fp32 K2/K3's split passes
over the tensor cores' 989 TFLOP/s for fp16, 495 for TF32), the larger;
``library_ms`` the time of one PyTorch call computing the same function,
where there is one (else null).
"""

from __future__ import annotations

import argparse
import collections
import copy
import functools
import json
import subprocess
import sys
import tempfile
import time

import torch

BENCH = dict(block_size=256, vocab_size=128, n_layer=6, n_head=6, n_embd=384,
             dropout=0.0, bias=False, dtype=torch.bfloat16, kv_quantized=True,
             n_kv_head=2, flat_kv=True)
BATCH, PROMPT_LEN, MAX_NEW, WINDOW = 4096, 8, 500, 128
# GPTConfig's default block_size: the long cache of the kernel checks
LONG = 1024
KERNEL_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/gqa_decode.cu"
KERNEL_RING_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/gqa_decode_ring.cu"
# K1 at G = 1 (H == KH: the TunesFormer, MoE and GPT-2 steps)
KERNEL_MHA_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/gqa_decode_mha.cu"
KERNEL_MHA_RING_SOURCE = (
    "ai_music_generation_tpu_torch/ops/csrc/gqa_decode_mha_ring.cu")
KERNEL_REPLACES = "ai_music_generation_tpu/ops/gqa_decode.py:394"
# the training path's dropout; it replaces no TPU kernel (XLA fuses the JAX
# package's)
DROPOUT_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/dropout.cu"
# speculative decoding: the bench config with MHA (the spec cache refuses
# GQA), at the protocol of docs/experiments/spec_decode.py and cli/sample.py
SPEC = dict(BENCH, n_kv_head=None)
N_DRAFT = 4
SPEC_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/spec_attention.cu"
SPEC_REPLACES = {"spec_attention_update":
                 "ai_music_generation_tpu/ops/spec_attention.py:450",
                 "spec_attention":
                 "ai_music_generation_tpu/ops/spec_attention.py:284"}
# the attn_impl="pallas" decode path: the bench widths with MHA and a bf16
# cache off the flat branch, so each T=1 step runs K4 (JAX gpt.py:724-734);
# Generator at its default window (block_size 256)
PALLAS = dict(BENCH, n_kv_head=None, kv_quantized=False, flat_kv=False,
              attn_impl="pallas")
PREFIX_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/decode_attention.cu"
PREFIX_REPLACES = {
    "decode_attention": "ai_music_generation_tpu/ops/decode_attention.py:163",
    "decode_attention_int8":
        "ai_music_generation_tpu/ops/decode_attention_int8.py:177",
    "decode_attention_int8_multirow":
        "ai_music_generation_tpu/ops/decode_attention_int8.py:339"}
# the lean T=1 attention of the int4 probe (K7) and the probe's path
LEAN_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/lean_attention.cu"
LEAN_REPLACES = "docs/experiments/int4_kernel_probe.py:216"
LEAN_MODES = ("lean8", "lean4")
# published H100 SXM peaks (NVIDIA's data sheet, at 700 W): device
# memory rate, the dense bf16 tensor-core rate, the peak for products
# whose widest input is bf16 (int8 caches meet bf16 queries here), and the
# dense int8 rate, for int8 x int8 products
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
# ... float32 outside the tensor cores (the fp32 K1's products), and the
# dense TF32 tensor-core rate (the fp32 K2's passes over an fp32 cache)
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# fp32 models (phases 16, 17): the bench widths at fp32. The fp32 kernels
# compute in fp32 throughout and round nothing, so they are held to 1e-5 of
# the output's range of the fp32 twin (summation order only); fp32 models
# on the card to 1e-4 of the logits' range of the CPU's (cuBLAS and the
# CPU's GEMMs sum in other orders, over 6 layers), 2^-8 with an int8 cache:
# a K or V value whose fp32 projection sits at a rounding tie quantizes to
# a neighbouring integer on one side, a step of 1/127 of its row's largest
# value (on an H100: 7e-4 of the range at the first prefill)
FP32_KERNEL_FRAC = 1e-5
FP32_MODEL_FRAC = 1e-4
FP32_INT8_MODEL_FRAC = 2.0 ** -8
FP32_BENCH = dict(BENCH, dtype=torch.float32)
FP32_MHA = dict(BENCH, dtype=torch.float32, n_kv_head=None,
                kv_quantized=False, flat_kv=False)
FP32_SPEC = dict(SPEC, dtype=torch.float32)
# the fp32 K2/K3: the tensor-core kernel's fp32 instantiation (its body in
# csrc/spec_attention_mma.cuh)
SPEC_F32_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/spec_attention_f32.cu"
# serving (phases 18, 19): docs/SERVING.md's headline configuration (the
# bench model, 8192 slots, a 128-column ring, waves of 512, 64 ticks a
# call) under cli/serve_bench.py's load (2 requests per slot, prompts of
# 4-48 tokens, 128-256 new tokens, T 0.8, top_k 64)
SERVE_SLOTS, SERVE_CACHE, SERVE_GROUP, SERVE_TICKS = 8192, 128, 512, 64
SERVE_REQUESTS, SERVE_MAX_NEW = 16384, 256
# the sampling CLI (phase 20): the real-path protocol of
# docs/experiments/realpath_bench_r5.py (irishman char, 4 conditioning
# measures, 1,000 samples at batch 1,000, 500 new tokens, T 0.8, top_k 200)
CLI_SAMPLES, CLI_NEW, CLI_SPEC_SAMPLES = 1000, 500, 64
CLI_S = BENCH["block_size"]  # its decode window (--window=0: block_size)
# training (phases 21-23): the music config (configs/irishman_char.py: 6
# layers, 6 heads, 384 wide, block 256, no bias, batch 64, dropout 0.2) on
# phase 20's corpus, and GPT-2 124M (cli/train_bench.py's defaults: 12
# layers, 12 heads, 768 wide, block 1024, batch 12, vocab 50304, bf16).
# A train step on the card is held to the CPU's within 1e-4 of the value
# (loss, grad_norm) or of the range (parameters) in fp32 (cuBLAS and the
# CPU sum in other orders), 2^-6 in bf16
MUSIC_CONFIG = "ai_music_generation_tpu_torch/configs/irishman_char.py"
TRAIN_STEP_FRAC = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
TRAIN_ITERS, TRAIN_EVAL, TRAIN_EVAL_ITERS = 30, 10, 5
BENCH_BURN_IN, BENCH_STEPS = 3, 10
# TunesFormer (phases 24-28): the reference model (TunesFormerConfig(): 9
# patch and 3 char layers, 768 wide, 12 heads, 128 patches of 32 chars,
# bf16); the generation protocol of docs/PERF.md (batch 16, 32 patches,
# top_p 0.8, top_k 8, T 1.2) and docs/SERVING.md's tunes headline (1,024
# slots) under cli/serve_bench.py's tunes load (4,096 requests, cut to one
# a slot for the script's time limit), all on cli/serve_bench.py's prompt
TUNES_H, TUNES_SIZE, TUNES_LENGTH = 12, 32, 128
TUNES_GEN_B, TUNES_GEN_BIG, TUNES_MAX_PATCH = 16, 1024, 32
TUNES_SLOTS, TUNES_REQUESTS = 1024, 1024
# the batches of the other tunes paths: the HTTP server's slots (phase 27),
# tunesformer_generate's tunes (phase 28; sample_tunesformer runs one a
# leadsheet)
TUNES_HTTP_SLOTS, TUNES_CLI_TUNES = 64, 8
TUNES_PROMPT = "S:2\nB:9\nE:4\nB:9\nL:1/8\nM:3/4\nK:D\n de|"
# TunesFormer training (phases 29-31): the train step card vs CPU at the
# reference widths cut to 2+1 layers (batch 2); the real path (500
# random_tunes curated into data.json, cli/tunesformer_train.py at its
# defaults for 2 epochs, a resume to 3, sampling TUNES_SHEETS leadsheets
# through K1); the MFU probe
# (experiments/tunes_mfu.py) at batches 8 and 32
TUNES_TRAIN_DEPTH = dict(patch_layers=2, char_layers=1)
TUNES_TRAIN_LR = 1e-3  # phase 29's peak lr, as the cuda test's
TUNES_TRAIN_B, TUNES_CORPUS, TUNES_EPOCHS, TUNES_SHEETS = 2, 500, 2, 4
TUNES_MFU_B = (8, 32)
# ABC -> WAV (phases 32-33): the eval pipeline's render (synth_batch 8,
# synthesize_midi_batch's 120 s at 16 kHz) and the JAX package's protocol
# (docs/PERF.md:11: 1,000 random ABC tunes of cli/random_baselines.py's
# recipe through cli/abc_to_midi_wav_and_aesthetics.py, proxy scorer), cut
# to 128 tunes to keep the script inside its time limit. The
# card's render is held to the CPU's within 1e-5 of each wave's range
# (CUDA's and the CPU's exp and sin differ by an ulp; every index, mask and
# trim is computed from equal bits)
SYNTH_BATCH, SYNTH_SECONDS, SYNTH_RATE, SYNTH_TUNES = 8, 120, 16_000, 128
SYNTH_SEED = 7
SYNTH_FRAC = 1e-5
# the Audiobox scorer (phases 34-35): AudioboxConfig() (WavLM base, fp32)
# from a seeded init, 10-s chunks at 16 kHz, timed at AesPredictor's batch
# (8) and audio-aes's (10); card vs CPU within 1e-4 of the range (the fp32
# yardstick of phases 17 and 25); cli/audio_aes.py over phase 33's
# SYNTH_TUNES WAVs, EvalPipeline over its first 32 tunes. AUDIOBOX_WAVLM
# overrides WavLMConfig's fields (none on the card; narrow widths to
# rehearse)
AUDIOBOX_WAVLM: dict = {}
AUDIOBOX_SEED, AUDIOBOX_CHUNK, AUDIOBOX_FRAC = 0, 160_000, 1e-4
AUDIOBOX_BATCHES, AUDIOBOX_ITERS, AUDIOBOX_PIPELINE_TUNES = (8, 10), 5, 32


def bound(n_bytes, n_ops, ops_per_s=BF16_OPS_PER_S) -> tuple[float, str]:
    """The least time (ms) the card could take for work that moves
    ``n_bytes`` (each input read once, each output written once) and does
    ``n_ops`` operations at ``ops_per_s``, and which of the two sets it."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                             "operations")


def _cmd(args) -> str:
    proc = subprocess.run(args, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{args[0]} failed: {proc.stderr}")
    return proc.stdout.strip()


def phase_environment() -> str:
    from torch.utils import cpp_extension

    from ai_music_generation_tpu_torch.ops import _build

    card = _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} "
          f"(sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}), "
          f"{torch.cuda.device_count()} visible")
    print(_cmd([_build._nvcc(), "--version"]).splitlines()[-1])
    print(f"ninja available: {cpp_extension.is_ninja_available()}")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    from ai_music_generation_tpu_torch.ops import _build

    path = _build.library_path()
    t0 = time.perf_counter()
    _build.build(path)
    print(f"built {path.name} from {[p.name for p in _build.sources()]} "
          f"in {time.perf_counter() - t0:.1f} s")
    print(path.with_suffix(".log").read_text().strip())
    _build.load_library()


def _decode_inputs(quant, ring, pos, B, S, H=6, KH=2, D=64, seed=0):
    """CPU tensors for one decode step (arguments of gqa_decode_update),
    fresh copies each call (the op writes its caches in place): only
    ``mask_rel`` depends on ``pos``, so the draw of the last configuration
    is kept (drawing B=4096 caches on the host costs seconds)."""
    *args, lengths = _decode_draw(quant, ring, B, S, H, KH, D, seed)
    args = [None if a is None else a.clone() for a in args]
    if ring:
        offset = (pos - torch.arange(S)) % S
        args.append((lengths[:, None] - offset[None, :]).to(torch.int32))
    else:
        args.append(None)
    return args


@functools.lru_cache(maxsize=1)
def _decode_draw(quant, ring, B, S, H, KH, D, seed):
    """_decode_inputs' random draw: q, k, v, k_slab, v_slab, k_scale,
    v_scale and the ring rows' lengths (None in lockstep)."""
    g = torch.Generator().manual_seed(seed)
    bf = lambda *shape: torch.randn(shape, generator=g).to(torch.bfloat16)  # noqa
    q, k_slab, v_slab = bf(B, H, D), bf(B, KH * D), bf(B, KH * D)
    if quant:
        k, v = (torch.randint(-127, 128, (B, S, KH * D), generator=g,
                              dtype=torch.int8) for _ in range(2))
        k_scale, v_scale = ((torch.rand((B, KH, S), generator=g) * 0.1
                             + 0.01).to(torch.bfloat16) for _ in range(2))
    else:
        k, v = bf(B, S, KH * D), bf(B, S, KH * D)
        k_scale = v_scale = None
    lengths = torch.randint(0, S, (B,), generator=g) if ring else None
    return q, k, v, k_slab, v_slab, k_scale, v_scale, lengths


def _to(args, device):
    return [None if a is None else a.to(device) for a in args]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _upcast(args):
    """The same inputs with q and the fresh K/V slabs upcast (exactly) to
    fp32, and fresh copies of the caches: the twin then evaluates the
    kernel's math in fp32."""
    return [None if a is None else
            (a.float() if i in (0, 3, 4) else a.clone())
            for i, a in enumerate(args)]


def phase_kernel_vs_twin(device, B=BATCH, S=WINDOW) -> float:
    """Caches and scales must equal the twin's bit for bit. The output is
    held against the twin evaluated in fp32 (the kernel's own precision)
    within one bf16 ulp of its largest value, 2^-7 of the range: the kernel
    rounds once, to bf16, and fp32 summation order moves nothing near that.
    Its distance from the bf16 twin (which rounds scores and probabilities
    to bf16, as the JAX reference does) is printed too. Returns the largest
    error against the fp32 twin."""
    from ai_music_generation_tpu_torch.ops.gqa_decode import (
        gqa_decode_reference, gqa_decode_update,
    )

    worst32 = worst16 = 0.0
    # B rows in the bench config's two modes (KH=2, int8 cache: the decode
    # path's lockstep and the serving tick's ring) at the first and the
    # last position (their twins run on the host, seconds a case); every
    # mode at KH 2 and 6, with the tile edges 7 and 8, at 3 rows
    cases = [(B, S, 2, True, ring, pos) for ring in (False, True)
             for pos in (0, S - 1)]
    cases += [(3, S, kh, quant, ring, pos) for kh in (2, 6)
              for quant in (True, False) for ring in (False, True)
              for pos in (0, 7, 8, S - 1)]
    # a long cache (8 staged tiles of columns): MHA bf16 and GQA int8
    cases += [(3, LONG, kh, quant, ring, pos)
              for kh, quant in ((6, False), (2, True))
              for ring in (False, True) for pos in (0, 7, 8, LONG - 1)]
    # cli/sample.py's decode step: 1,000 rows over the block_size window
    # (two staged tiles), GQA int8 lockstep
    cases += [(CLI_SAMPLES, CLI_S, 2, True, False, pos)
              for pos in (0, 7, 8, CLI_S - 1)]
    for b, s_len, kh, quant, ring, pos in cases:
        cpu = _decode_inputs(quant, ring, pos, b, s_len, KH=kh)
        cpu32, dev = _upcast(cpu), _to(cpu, device)
        out = gqa_decode_update(*dev, torch.tensor(
            pos, dtype=torch.int32, device=device))
        pos_cpu = torch.tensor(pos, dtype=torch.int32)
        ref = gqa_decode_update(*cpu, pos_cpu)
        ref32 = gqa_decode_reference(*cpu32, pos_cpu)
        _sync(device)
        for name, got, want in zip(
                ("k", "v", "k_slab", "v_slab", "k_scale",
                 "v_scale"), dev[1:7], cpu[1:7]):
            if got is not None and not torch.equal(got.cpu(),
                                                   want):
                raise AssertionError(
                    f"{name} differs: B={b} S={s_len} KH={kh} quant="
                    f"{quant} ring={ring} pos={pos}")
        out = out.float().cpu()
        err = (out - ref32).abs().max().item()
        tol = 2.0 ** -7 * ref32.abs().max().item()
        if not err <= tol:
            raise AssertionError(
                f"out differs from the fp32 twin by {err} > "
                f"{tol}: B={b} S={s_len} KH={kh} quant={quant} "
                f"ring={ring} pos={pos}")
        worst32 = max(worst32, err)
        worst16 = max(worst16,
                      (out - ref.float()).abs().max().item())
    print(f"kernel vs twin: G=3 int8 lockstep and ring at B={B} (pos 0, "
          f"{S - 1}), 4 modes x G (3, 1) at B=3 (pos 0, 7, 8, {S - 1}), "
          f"S={S}, B=3, S={LONG} (MHA bf16, "
          f"G=3 int8; "
          f"pos 0, 7, 8, {LONG - 1}) and the sample CLI's B={CLI_SAMPLES}, "
          f"S={CLI_S} (G=3 int8 lockstep; pos 0, 7, 8, {CLI_S - 1}): caches "
          f"and scales bit-exact; out max abs err {worst32} vs the fp32 twin,"
          f" {worst16} vs the bf16 twin")
    return worst32


def _cuda_ms(fn, iters) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel_timing(B=BATCH, S=WINDOW) -> dict:
    """ms per call of the kernel and of the plain twin on the card, at the
    decode shape, int8 lockstep at pos = S-1 (the whole window valid). The
    K+V caches (128 MiB at B=4096) exceed the 50 MB L2, so every call reads
    them from device memory, as the decode loop does. Returns the kernel's
    JSON numbers, with its bound; no one PyTorch call fuses the quantize,
    the writes and the attention, so there is no library time."""
    from ai_music_generation_tpu_torch.ops.gqa_decode import (
        gqa_decode_reference, gqa_decode_update,
    )

    args = _to(_decode_inputs(True, False, S - 1, B, S), "cuda")
    pos = torch.tensor(S - 1, dtype=torch.int32, device="cuda")
    kernel, plain = [], []
    for order in (0, 1, 1, 0):  # plain, kernel, kernel, plain
        if order:
            kernel.append(_cuda_ms(lambda: gqa_decode_update(*args, pos), 50))
        else:
            plain.append(_cuda_ms(
                lambda: gqa_decode_reference(*args, pos), 20))
    ms, plain_ms = min(kernel), min(plain)
    cache_bytes = 2 * args[1].numel() + 2 * 2 * args[5].numel()
    q, k, _, k_slab, _, k_scale = args[:6]
    KHD, KH = k.shape[2], k_scale.shape[1]
    # reads: q, the S-1 older columns of K, V and their scales, the slabs;
    # writes: the fresh column of K, V and their scales, out
    n_bytes = (2 * q.nbytes + 2 * B * (S - 1) * KHD + 2 * 2 * B * KH * S
               + 2 * k_slab.nbytes + 2 * B * KHD)
    bound_ms, bound_by = bound(n_bytes, 4 * q.numel() * S)
    print(f"gqa_decode at B={B} S={S} int8: kernel {kernel} ms/call, twin "
          f"{plain} ms/call (plain, kernel, kernel, plain); best kernel "
          f"{ms:.4f} ms = {cache_bytes / ms / 1e6:.1f} GB/s of cache read, "
          f"twin {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_bytes / 1e6:.1f} MB), {bound_ms / ms:.3f} of it")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def _bench_model(device, config=BENCH):
    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig

    model = GPT(GPTConfig(**config), device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    return model.eval(), copy.deepcopy(model).to(device).eval()


@torch.inference_mode()
def phase_model(device, B=BATCH, rows=8, steps=16, config=BENCH,
                window=WINDOW, frac=2.0 ** -4) -> None:
    """Teacher-forced prefill + decode steps of the ``config`` model (cache
    of ``window`` columns, default block_size) on the card and on the CPU
    with the same weights; logits agree within ``frac`` of their range: in
    bf16 2^-4 (8 bf16 ulps at the largest logit: cuBLAS and the kernel round
    at other places than the CPU's matmuls and the twin, over 6 layers), in
    fp32 FP32_MODEL_FRAC."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache

    cpu_model, model = _bench_model(device, config)
    cfg = model.config
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT_LEN + steps),
                        generator=g, dtype=torch.int32)
    caches = (KVCache.create(cfg, B, window, device=device),
              KVCache.create(cfg, rows, window, device="cpu"))
    worst, tol, rng, flips = 0.0, 0.0, 0.0, None
    for lo, hi in [(0, PROMPT_LEN)] + [
            (t, t + 1) for t in range(PROMPT_LEN, PROMPT_LEN + steps)]:
        got, _ = model(ids[:, lo:hi].to(device), cache=caches[0])
        want, _ = cpu_model(ids[:rows, lo:hi], cache=caches[1])
        got = got[:rows].float().cpu()
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite logits on the card")
        err = (got - want.float()).abs().max().item()
        rng = max(rng, want.float().abs().max().item())
        tol = frac * rng
        if not err <= tol:
            raise AssertionError(f"logits differ by {err} > {tol} at {lo}")
        worst = max(worst, err)
        if cfg.kv_quantized and flips is None and err > FP32_MODEL_FRAC * rng:
            flips = (lo, err / rng, _int8_flips(caches, rows))
    print(f"model ({cfg.dtype}, attn_impl={cfg.attn_impl}, n_kv_head="
          f"{cfg.n_kv_head}, kv_quantized={cfg.kv_quantized}, flat_kv="
          f"{cfg.flat_kv}): prefill "
          f"{PROMPT_LEN} + {steps} decode steps at B={B}, {rows} rows vs "
          f"CPU: logits max abs err {worst} = {worst / rng:.3e} of the range "
          f"(tol {tol})")
    if flips is not None:
        lo, share, (diff, n, step, scales, n_scales) = flips
        print(f"  int8 caches at the first step over {FP32_MODEL_FRAC} of the "
              f"range (position {lo}, {share:.3e}): {diff} of {n} int8 values"
              f" differ card vs CPU, by at most {step}; {scales} of "
              f"{n_scales} scales differ")


def _int8_flips(caches, rows):
    """(int8 values that differ between the card's cache (its first
    ``rows`` rows) and the CPU's, values compared, the largest difference,
    scales that differ, scales compared) over every layer's K and V."""
    diff = n = step = scales = n_scales = 0
    for name in ("k", "v"):
        for a, b in zip(getattr(caches[0], name), getattr(caches[1], name)):
            d = (a[:rows].cpu().int() - b.int()).abs()
            diff, n = diff + int((d > 0).sum()), n + d.numel()
            step = max(step, int(d.max()))
        for a, b in zip(getattr(caches[0], f"{name}_scale"),
                        getattr(caches[1], f"{name}_scale")):
            scales += int((a[:rows].cpu() != b).sum())
            n_scales += b.numel()
    return diff, n, step, scales, n_scales


@torch.inference_mode()
def phase_main_path(device, B=BATCH, max_new=MAX_NEW):
    """Two same-seed generates at the bench protocol, checked; returns
    (generator, prompts, kernel launches per generate)."""
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update

    _, model = _bench_model(device)
    cfg = model.config
    gen = Generator(model, max_new_tokens=max_new, temperature=0.8,
                    top_k=200, window=WINDOW)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(2),
                            dtype=torch.int32)
    runs = []
    for _ in range(2):
        gqa_decode_update.launches = 0
        out = gen.generate(prompts, seed=1234)
        _sync(device)
        runs.append((out.cpu(), gqa_decode_update.launches))
    (out, launches), (again, launches2) = runs
    if out.shape != (B, PROMPT_LEN + max_new):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT_LEN], prompts):
        raise AssertionError("prompts not preserved")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("token out of range")
    if not torch.equal(out, again):
        raise AssertionError("same seed gave different tokens")
    # every decode step of every layer launches the kernel once (a CPU
    # rehearsal runs the twin and launches nothing)
    want = cfg.n_layer * max_new if torch.device(device).type == "cuda" else 0
    if not launches == launches2 == want:
        raise AssertionError(
            f"kernel launches per generate {launches}, {launches2} != {want}")
    print(f"main path: generate [{B}, {PROMPT_LEN}] -> {tuple(out.shape)}, "
          f"prompts kept, tokens in range, same seed identical, "
          f"{launches} kernel launches per generate")
    return gen, prompts, launches


@torch.inference_mode()
def phase_throughput(gen, prompts, runs=3) -> float:
    """Decode tokens/s over ``runs`` generates after the warm-up, timed with
    CUDA events (each run: prefill, 500 steps, refresh re-prefills)."""
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for i in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gen.generate(prompts, seed=1235 + i)
        end.record()
        torch.cuda.synchronize()
        seconds.append(start.elapsed_time(end) / 1e3)
    tok_s = prompts.shape[0] * gen.max_new_tokens / (sum(seconds) / runs)
    print(f"main path: {runs} timed generates {seconds} s, {tok_s:.1f} "
          f"tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return tok_s


def _spec_inputs(quant, T, cursor, B, S, H=6, D=64, seed=0, device="cpu",
                 n_live=None):
    """Operands of one verify call, made on ``device`` from a seed (the
    generator of tests/test_torch_spec_attention.py::make_inputs): row b
    has n_b live history columns outside the write window at positions
    0..n_b-1 (a tenth of them killed, as rejected drafts are), the T fresh
    columns at ``cursor`` at positions n_b.., every other column dead.
    ``n_live`` fixes n_b for every row and kills none."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache

    g = torch.Generator(device=device).manual_seed(seed)
    HD, Tw = H * D, -(-T // 8) * 8
    kw = dict(generator=g, device=device)
    hist = torch.cat([torch.arange(cursor, device=device),
                      torch.arange(cursor + Tw, S, device=device)])
    nvalid = (torch.randint(0, S - Tw + 1, (B,), **kw) if n_live is None
              else torch.full((B,), n_live, device=device))
    rank = torch.arange(len(hist), device=device)
    dead = KVCache.INVALID_POS
    col_pos = torch.full((B, S), dead, dtype=torch.int64, device=device)
    col_pos[:, hist] = torch.where(rank[None] < nvalid[:, None], rank[None],
                                   dead)
    if n_live is None:
        col_pos[torch.rand((B, S), **kw) < 0.1] = dead
    col_pos[:, cursor:cursor + T] = nvalid[:, None] + torch.arange(
        T, device=device)
    bf = lambda *shape: torch.randn(shape, **kw).to(torch.bfloat16)  # noqa
    if quant:
        k, v, k_slab, v_slab = (torch.randint(
            -127, 128, (B, n, HD), dtype=torch.int8, **kw)
            for n in (S, S, Tw, Tw))
        k_scale, v_scale = ((torch.rand((B, H, S), **kw) * 0.02
                             + 0.002).to(torch.bfloat16) for _ in range(2))
    else:
        k, v = bf(B, S, HD), bf(B, S, HD)
        k_slab, v_slab = bf(B, Tw, HD), bf(B, Tw, HD)
        k_scale = v_scale = None
    return dict(q=bf(B, T, HD), k=k, v=v, k_slab=k_slab, v_slab=v_slab,
                k_scale=k_scale, v_scale=v_scale,
                col_pos=col_pos.to(torch.int32),
                lengths=nvalid.to(torch.int32),
                cursor=torch.tensor(cursor, dtype=torch.int32, device=device))


SPEC_ATT = ("q", "k", "v", "k_scale", "v_scale", "col_pos", "lengths")
SPEC_UPD = ("q", "k", "v", "k_slab", "v_slab", "k_scale", "v_scale",
            "col_pos", "lengths", "cursor")


def phase_spec_kernel_vs_twin(device, B=BATCH, S=256, H=6, D=64):
    """K2 and K3 against the twins at the verify, prefill and refresh
    widths. K2's write must equal the twin's bit for bit; the output is
    held against the twin evaluated in fp32 on the card (q upcast exactly;
    TF32 off) within one bf16 ulp of its range, 2^-7 (2^-6 in int8_dots
    mode, where a probability may quantize to a neighbouring integer).
    Returns the largest error of each kernel."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache
    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention, spec_attention_int8_dots_reference,
        spec_attention_reference, spec_attention_update, write_slab,
    )

    worst = {"spec_attention_update": 0.0, "spec_attention": 0.0}
    cases = 0
    # at B=3 also the edges of the kernel's regimes (verify T <= 16,
    # refresh tiles of 64 queries), with an added row that reads nothing;
    # over the long cache a refresh takes 16-query tiles
    for b, s_len, Ts in ((B, S, (1, 5, 7, 128)),
                         (3, S, (1, 5, 7, 8, 16, 17, 64, 65, 128)),
                         (3, LONG, (5, 17, 64, 65, 128))):
        edges = b == 3
        for T in Ts:
            Tw = -(-T // 8) * 8
            for mode in ("int8", "bf16", "int8_dots"):
                quant, dots = mode != "bf16", mode == "int8_dots"
                twin = (spec_attention_int8_dots_reference if dots
                        else spec_attention_reference)
                for write, cursors in ((True, (0, 8, s_len - Tw)),
                                       (False, (s_len - Tw,))):
                    for cursor in cursors:
                        x = _spec_inputs(quant, T, cursor, b + edges, s_len,
                                         H, D, seed=T + cursor, device=device)
                        if edges:  # the added row
                            x["col_pos"][-1] = KVCache.INVALID_POS
                        ref_k, ref_v = x["k"].clone(), x["v"].clone()
                        if write:
                            out = spec_attention_update(
                                *[x[n] for n in SPEC_UPD], n_head=H,
                                int8_dots=dots)
                            write_slab(ref_k, ref_v, x["k_slab"],
                                       x["v_slab"], x["cursor"])
                        else:
                            out = spec_attention(*[x[n] for n in SPEC_ATT],
                                                 n_head=H, int8_dots=dots)
                        _sync(device)
                        if not (torch.equal(x["k"], ref_k)
                                and torch.equal(x["v"], ref_v)):
                            raise AssertionError(
                                f"cache write differs: B={b} S={s_len} T={T}"
                                f" cursor={cursor} {mode}")
                        ref = twin(x["q"].float(), ref_k, ref_v,
                                   *[x[n] for n in SPEC_ATT[3:]], n_head=H)
                        if edges:  # the dead row: 0 here, NaN in the twin
                            if not torch.equal(out[-1],
                                               torch.zeros_like(out[-1])):
                                raise AssertionError(
                                    f"dead row not 0: S={s_len} T={T} "
                                    f"{mode}")
                            out, ref = out[:-1], ref[:-1]
                        err = (out.float() - ref).abs().max().item()
                        tol = 2.0 ** (-6 if dots else -7) * \
                            ref.abs().max().item()
                        name = ("spec_attention_update" if write
                                else "spec_attention")
                        if not err <= tol:
                            raise AssertionError(
                                f"{name} differs from the fp32 twin by "
                                f"{err} > {tol}: B={b} S={s_len} T={T} "
                                f"cursor={cursor} {mode}")
                        worst[name] = max(worst[name], err)
                        cases += 1
                        del x, ref_k, ref_v, out, ref
    print(f"spec kernel vs twin: {cases} cases (K2 and K3; int8, bf16, "
          f"int8_dots; cursors 0, 8, S-Tw) at B={B} (T 1, 5, 7, 128) and "
          f"B=3 + a dead row (T 1, 5, 7, 8, 16, 17, 64, 65, 128), S={S}, and"
          f" B=3 + a dead row over S={LONG} (T 5, 17, 64, 65, 128): writes "
          f"bit-exact; out max abs err vs the fp32 twin {worst}")
    return worst


def _spec_work(x, T, n_live, H, write):
    """(bytes, operations) of one verify call whose every query reads the
    ``n_live`` history columns and the fresh columns up to its own: reads
    q, col_pos, lengths, the live K/V columns (the fresh ones from the slab
    with the write, else from the cache) and their scales; writes out and,
    with the write, the slab into the cache."""
    B, S, HD = x["k"].shape
    D, Tw, item = HD // H, -(-T // 8) * 8, x["k"].element_size()
    fresh = Tw if write else T
    n = (2 * x["q"].nbytes + x["col_pos"].nbytes + x["lengths"].nbytes
         + 2 * B * (n_live + fresh) * HD * item
         + (2 * B * Tw * HD * item if write else 0))
    if x["k_scale"] is not None:
        n += 2 * 2 * B * H * (n_live + T)
    return n, 4 * B * H * D * (T * n_live + T * (T + 1) // 2)


def phase_spec_kernel_timing(S=256, H=6, D=64, B=BATCH):
    """ms per call of K2 and its plain twin (write_slab + the bf16
    reference, what the op runs on the CPU) at B=4096 with an int8 cache:
    a verify step (T=5, cursor S-8, every history column live: the most a
    step reads) and a refresh (T=128 at cursor 0 over an empty history),
    in the order plain, kernel, kernel, plain; K3 at the verify step, with
    the int8 cache and with a bf16 one, where one PyTorch call computes the
    same function: ``scaled_dot_product_attention`` under the boolean mask
    built from col_pos beforehand (timed library, kernel, kernel, library).
    Returns {name: the kernel's JSON numbers}: K2 and K3 (bf16) at the
    verify step, K2 at the refresh."""
    import torch.nn.functional as F

    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention, spec_attention_reference, spec_attention_update,
        write_slab,
    )

    def plain_update(x):
        write_slab(x["k"], x["v"], x["k_slab"], x["v_slab"], x["cursor"])
        return spec_attention_reference(*[x[n] for n in SPEC_ATT], n_head=H)

    def numbers(kernel, plain, work, library=None):
        bound_ms, bound_by = bound(*work)
        return dict(ms=min(kernel), plain_ms=min(plain), bound_ms=bound_ms,
                    bound_by=bound_by,
                    library_ms=None if library is None else min(library))

    res = {}
    for label, T, cursor, n_live in (("verify", 5, S - 8, S - 8),
                                     ("refresh", 128, 0, 0)):
        x = _spec_inputs(True, T, cursor, B, S, H, D, seed=1, device="cuda",
                         n_live=n_live)
        kernel, plain = [], []
        for order in (0, 1, 1, 0):
            if order:
                kernel.append(_cuda_ms(lambda: spec_attention_update(
                    *[x[n] for n in SPEC_UPD], n_head=H), 20))
            else:
                plain.append(_cuda_ms(lambda: plain_update(x), 5))
        name = "spec_attention_update" if label == "verify" else label
        res[name] = r = numbers(kernel, plain,
                                _spec_work(x, T, n_live, H, True))
        read = (2 * B * (n_live + T) * H * D  # live K and V columns
                + 2 * 2 * B * H * S)  # the bf16 scale rows
        print(f"spec_attention_update {label} (B={B} S={S} T={T} int8, "
              f"{n_live} live history columns): kernel {kernel} ms/call, "
              f"twin {plain} ms/call (plain, kernel, kernel, plain); best "
              f"kernel {r['ms']:.4f} ms = {read / r['ms'] / 1e6:.1f} GB/s "
              f"of cache read, twin {r['plain_ms']:.4f} ms; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.3f} of it")
        if label == "verify":
            for quant in (True, False):
                lib_call = None
                if not quant:
                    x = _spec_inputs(False, T, cursor, B, S, H, D, seed=1,
                                     device="cuda", n_live=n_live)
                    qv, kv, vv = (x[n].view(B, -1, H, D).transpose(1, 2)
                                  for n in ("q", "k", "v"))
                    mask = (x["col_pos"][:, None, None, :] <= (
                        x["lengths"][:, None] + torch.arange(
                            T, device="cuda"))[:, None, :, None])
                    lib_call = lambda: F.scaled_dot_product_attention(  # noqa
                        qv, kv, vv, attn_mask=mask)
                k3, p3, lib = [], [], []
                for order in ("plain", "library", "kernel", "kernel",
                              "library", "plain"):
                    if order == "plain":
                        p3.append(_cuda_ms(lambda: spec_attention_reference(
                            *[x[n] for n in SPEC_ATT], n_head=H), 5))
                    elif order == "kernel":
                        k3.append(_cuda_ms(lambda: spec_attention(
                            *[x[n] for n in SPEC_ATT], n_head=H), 20))
                    elif lib_call is not None:
                        lib.append(_cuda_ms(lib_call, 20))
                r = numbers(k3, p3, _spec_work(x, T, n_live, H, False),
                            lib or None)
                if not quant:
                    res["spec_attention"] = r
                print(f"spec_attention verify {'int8' if quant else 'bf16'}"
                      f": kernel {k3} ms/call, twin {p3} ms/call"
                      + (f", scaled_dot_product_attention {lib} ms/call"
                         if lib else "")
                      + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}),"
                      f" {r['bound_ms'] / r['ms']:.3f} of it")
        del x
    return res


@torch.inference_mode()
def phase_spec_model(device, B=BATCH, rows=8, verify_steps=4, config=SPEC,
                     frac=2.0 ** -4):
    """The spec-mode ``config`` model (default SPEC) on the card and the
    same weights on the CPU: a 7-token prefill, ``verify_steps`` T=5 steps
    each followed by scripted rejections (the SpecGenerator's bookkeeping
    with random commit counts), then a refresh (reset, 128-token
    re-prefill). Logits within ``frac`` of their range (the yardstick of
    phase 4 in bf16)."""
    from ai_music_generation_tpu_torch.decode.speculative import (
        keep_committed, reset_spec_cache,
    )
    from ai_music_generation_tpu_torch.models.gpt import KVCache

    cpu_model, model = _bench_model(device, config)
    cfg = model.config
    g = torch.Generator().manual_seed(3)
    caches = (KVCache.create(cfg, B, device=device, spec=True),
              KVCache.create(cfg, rows, device="cpu", spec=True))
    T = N_DRAFT + 1
    worst, tol, rng, flips = 0.0, 0.0, 0.0, None
    for n in [PROMPT_LEN - 1] + [T] * verify_steps + ["refresh", 128]:
        if n == "refresh":
            for c in caches:
                reset_spec_cache(c)
            continue
        ids = torch.randint(0, cfg.vocab_size, (B, n), generator=g,
                            dtype=torch.int32)
        before = [(c.cursor.clone(), c.length.clone()) for c in caches]
        got, _ = model(ids.to(device), cache=caches[0],
                       return_all_logits=True)
        want, _ = cpu_model(ids[:rows], cache=caches[1],
                            return_all_logits=True)
        got = got[:rows].float().cpu()
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite logits on the card")
        err = (got - want.float()).abs().max().item()
        rng = max(rng, want.float().abs().max().item())
        tol = frac * rng
        if not err <= tol:
            raise AssertionError(f"spec logits differ by {err} > {tol} "
                                 f"(call of T={n})")
        worst = max(worst, err)
        if cfg.kv_quantized and flips is None and err > FP32_MODEL_FRAC * rng:
            flips = (n, err / rng, _int8_flips(caches, rows))
        if n == T:
            commits = torch.randint(1, T + 1, (B,), generator=g,
                                    dtype=torch.int32)
            for c, (cursor0, length0), cm in zip(
                    caches, before, (commits.to(device), commits[:rows])):
                keep_committed(c, cursor0, length0, cm, T)
    if not torch.equal(caches[0].col_pos[:rows].cpu(), caches[1].col_pos):
        raise AssertionError("col_pos differs between the card and the CPU")
    print(f"spec model ({cfg.dtype}, kv_quantized={cfg.kv_quantized}): "
          f"prefill {PROMPT_LEN - 1} + {verify_steps} verify "
          f"steps (T={T}, scripted rejections) + refresh (T=128) at B={B}, "
          f"{rows} rows vs CPU: logits max abs err {worst} = "
          f"{worst / rng:.3e} of the range (tol {tol})")
    if flips is not None:
        n, share, (diff, n_vals, step, scales, n_scales) = flips
        print(f"  int8 caches at the first call over {FP32_MODEL_FRAC} of the "
              f"range (T={n}, {share:.3e}): {diff} of {n_vals} int8 values "
              f"differ card vs CPU, by at most {step}; {scales} of "
              f"{n_scales} scales differ")


def _spec_run(gen, prompts, prompt_lens=None, seed=1234):
    """One generate_with_stats with the model calls recorded by a hook
    (independently of the kernel's counter) and the kernel's launches;
    returns (tokens on the CPU, n_steps, the T of each call, launches)."""
    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention_update,
    )

    calls = []
    handle = gen.model.register_forward_pre_hook(
        lambda _, args: calls.append(args[0].shape[1]))
    try:
        spec_attention_update.launches = 0
        out, n_steps = gen.generate_with_stats(prompts, prompt_lens,
                                               seed=seed)
        _sync(out.device)
        launches = spec_attention_update.launches
    finally:
        handle.remove()
    return out.cpu(), n_steps, calls, launches


def _check_spec_run(gen, out, n_steps, calls, launches, device, prefill):
    """The launch and step accounting of one spec generate: every model
    call (the prefill of ``prefill - 1`` tokens, the verify steps, the
    refreshes) launches the kernel once per layer, and
    ceil(committed/(K+1)) <= n_steps <= committed."""
    K, C = gen.n_draft, gen.window
    refreshes = calls.count(C)
    if calls[0] != prefill - 1 or calls.count(K + 1) != n_steps or \
            len(calls) != 1 + n_steps + refreshes:
        raise AssertionError(f"model calls {calls[:3]}..., {len(calls)} in "
                             f"all, for {n_steps} steps")
    cuda = torch.device(device).type == "cuda"
    want = gen.model.config.n_layer * len(calls) if cuda else 0
    if launches != want:
        raise AssertionError(f"spec kernel launches {launches} != {want} "
                             f"= n_layer x {len(calls)} model calls")
    committed = out.shape[1] - prefill
    if not -(-committed // (K + 1)) <= n_steps <= committed:
        raise AssertionError(f"n_steps {n_steps} outside its bounds for "
                             f"{committed} committed tokens")
    return refreshes, committed / n_steps


@torch.inference_mode()
def phase_spec_main_path(device, B=BATCH, max_new=MAX_NEW):
    """The speculative path at the protocol, through SpecGenerator: two
    same-seed runs, a ragged-prompt run and a greedy run, all checked.
    Returns (generator, prompts, launches of the first run, its n_steps,
    committed tokens per step)."""
    from ai_music_generation_tpu_torch.decode.speculative import (
        SpecGenerator,
    )

    _, model = _bench_model(device, SPEC)
    V = model.config.vocab_size
    gen = SpecGenerator(model, max_new_tokens=max_new, temperature=0.8,
                        top_k=200, n_draft=N_DRAFT)
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, V, (B, PROMPT_LEN), generator=g,
                            dtype=torch.int32)
    out, n_steps, calls, launches = _spec_run(gen, prompts)
    again = _spec_run(gen, prompts)
    refreshes, per_step = _check_spec_run(gen, out, n_steps, calls,
                                          launches, device, PROMPT_LEN)
    if out.shape != (B, PROMPT_LEN + max_new):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT_LEN], prompts):
        raise AssertionError("prompts not preserved")
    if not ((out >= 0) & (out < V)).all():
        raise AssertionError("token out of range")
    if not (torch.equal(out, again[0]) and again[1:] == (n_steps, calls,
                                                           launches)):
        raise AssertionError("same seed gave different runs")
    print(f"spec main path: generate [{B}, {PROMPT_LEN}] -> "
          f"{tuple(out.shape)}, prompts kept, tokens in range, same seed "
          f"identical; {n_steps} verify steps + {refreshes} refreshes + 1 "
          f"prefill, {launches} kernel launches = n_layer x model calls; "
          f"{per_step:.3f} committed tokens per step")

    # ragged prompts of 8-64 tokens: in-prompt drafts are force-accepted
    plens = torch.randint(8, 65, (B,), generator=g, dtype=torch.int32)
    ragged = torch.randint(0, V, (B, 64), generator=g, dtype=torch.int32)
    r_out, r_steps, r_calls, r_launches = _spec_run(gen, ragged, plens)
    bucket = 1 << (min(int(plens.min()), gen.window).bit_length() - 1)
    _, r_per_step = _check_spec_run(gen, r_out, r_steps, r_calls, r_launches,
                                    device, bucket)
    keep = torch.arange(64)[None, :] < plens[:, None]
    if not torch.equal(r_out[:, :64][keep], ragged[keep]):
        raise AssertionError("ragged prompts not preserved")
    print(f"spec ragged prompts (8-64 tokens): prompts kept, {r_steps} "
          f"steps, {r_per_step:.3f} committed tokens per step")

    greedy = SpecGenerator(model, max_new_tokens=max_new, temperature=0.0,
                           top_k=None, n_draft=N_DRAFT)
    g_out, g_steps, g_calls, g_launches = _spec_run(greedy, prompts)
    _, g_per_step = _check_spec_run(greedy, g_out, g_steps, g_calls,
                                    g_launches, device, PROMPT_LEN)
    print(f"spec greedy: {g_steps} steps, {g_per_step:.3f} committed tokens "
          f"per step")
    return gen, prompts, launches, n_steps, per_step


def _event_seconds(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


@torch.inference_mode()
def phase_spec_throughput(gen, prompts):
    """Spec tokens/s (B * 500 / time of one generate) beside the plain
    Generator on the same SPEC model (window 256: its own default, K1 at
    MHA), one generate each in the order spec, plain after a plain warm-up
    (the spec path is warm from its main-path runs)."""
    from ai_music_generation_tpu_torch.decode.generate import Generator

    plain = Generator(gen.model, max_new_tokens=gen.max_new_tokens,
                      temperature=0.8, top_k=200)
    plain.generate(prompts, seed=99)
    seconds = {"plain": [], "spec": []}
    for i, name in enumerate(("spec", "plain")):
        g = plain if name == "plain" else gen
        seconds[name].append(_event_seconds(
            lambda: g.generate(prompts, seed=2000 + i)))
    n = prompts.shape[0] * gen.max_new_tokens
    tok_s = {k: n / (sum(v) / len(v)) for k, v in seconds.items()}
    print(f"throughput at B={prompts.shape[0]}, {gen.max_new_tokens} new "
          f"tokens: spec {tok_s['spec']:.1f} tok/s (generates "
          f"{seconds['spec']} s), plain Generator {tok_s['plain']:.1f} tok/s"
          f" ({seconds['plain']} s); spec/plain "
          f"{tok_s['spec'] / tok_s['plain']:.3f}")
    return tok_s


def _prefix_inputs(B, S, H, D, length, cache_dtype, seed=0, device="cpu"):
    """Operands of one valid-prefix decode call, made on ``device`` from a
    seed: q [B, HD] and the K/V cache [B, S, HD] in bf16 (K4), or bf16 q,
    an int8 cache and fp32 per-position scales [B, S] (K5, K6); every column
    from ``length`` on poisoned: NaN in the bf16 cache, int8 127 and scales
    1e4 in the int8 one (tests/test_decode_attention_int8.py:47-51).
    Returns (q, k, v, k_scale, v_scale, length tensor)."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    HD = H * D
    q = torch.randn((B, HD), **kw).to(torch.bfloat16)
    n = torch.tensor(length, dtype=torch.int32, device=device)
    if cache_dtype == torch.int8:
        k, v = (torch.randint(-127, 128, (B, S, HD), dtype=torch.int8, **kw)
                for _ in range(2))
        k_scale, v_scale = (torch.rand((B, S), **kw) * 0.02 + 0.002
                            for _ in range(2))
        k[:, length:], v[:, length:] = 127, 127
        k_scale[:, length:], v_scale[:, length:] = 1e4, 1e4
        return q, k, v, k_scale, v_scale, n
    k, v = (torch.randn((B, S, HD), **kw).to(torch.bfloat16)
            for _ in range(2))
    k[:, length:], v[:, length:] = float("nan"), float("nan")
    return q, k, v, None, None, n


def _check_close(out, ref, what, frac=2.0 ** -7):
    """The kernel yardstick: finite, and within ``frac`` of the range of
    the twin evaluated in fp32 (by default one bf16 ulp of the largest
    value, 2^-7). Returns the error."""
    out = out.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"non-finite output: {what}")
    err = (out - ref).abs().max().item()
    tol = frac * ref.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: differs from the fp32 twin by {err} > "
                             f"{tol}")
    return err


def phase_prefix_kernel_vs_twin(device, B=BATCH, S=256, H=6, D=64,
                                lengths=(1, 63, 64, 100, 255, 256)):
    """K4 against its twin evaluated in fp32 (q and the cache upcast
    exactly; TF32 off) at B=4096 and B=3, with every column from the length
    on NaN-poisoned. Returns the largest error."""
    from ai_music_generation_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference,
    )

    worst = 0.0
    for b in (B, 3):
        for length in lengths:
            q, k, v, _, _, n = _prefix_inputs(b, S, H, D, length,
                                              torch.bfloat16, seed=length,
                                              device=device)
            out = decode_attention(q, k, v, n, n_head=H)
            ref = decode_attention_reference(q.float(), k.float(), v.float(),
                                             n, n_head=H)
            worst = max(worst, _check_close(
                out, ref, f"decode_attention B={b} length={length}"))
            del q, k, v, out, ref
    print(f"decode_attention vs twin: B={B} and B=3, S={S}, H={H}, D={D}, "
          f"bf16, lengths {list(lengths)}, NaN past the length: finite, max "
          f"abs err {worst} vs the fp32 twin")
    return worst


def _prefix_work(q, k, k_scale, L):
    """(bytes, operations) of one valid-prefix call over L live columns:
    reads q, L columns of K and V and their scales; writes out."""
    B, S, HD = k.shape
    n = 2 * q.nbytes + 2 * B * L * HD * k.element_size()
    if k_scale is not None:
        n += 2 * B * L * k_scale.element_size()
    return n, 4 * B * L * HD


def phase_prefix_kernel_timing(B=BATCH, S=256, H=6, D=64, lengths=(128, 256)):
    """ms per call of K4, its plain twin, and the one PyTorch call that
    computes the same function (``scaled_dot_product_attention`` on the
    length-L prefix views) at the path's shape, B=4096 bf16, in the order
    plain, kernel, library, library, kernel, plain. The K+V prefix (0.8-1.6
    GB) exceeds the 50 MB L2, so every call reads it from device memory, as
    the decode loop does. Returns {L: the kernel's JSON numbers}."""
    import torch.nn.functional as F

    from ai_music_generation_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference,
    )

    res = {}
    for L in lengths:
        q, k, v, _, _, n = _prefix_inputs(B, S, H, D, L, torch.bfloat16,
                                          seed=7, device="cuda")
        q4 = q.view(B, H, 1, D)
        k4, v4 = (t[:, :L].view(B, L, H, D).transpose(1, 2) for t in (k, v))
        times = {"plain": [], "kernel": [], "library": []}
        for order in ("plain", "kernel", "library", "library", "kernel",
                      "plain"):
            fn = {"plain": lambda: decode_attention_reference(
                      q, k, v, n, n_head=H),
                  "kernel": lambda: decode_attention(q, k, v, n, n_head=H),
                  "library": lambda: F.scaled_dot_product_attention(
                      q4, k4, v4)}[order]
            times[order].append(_cuda_ms(fn, 5 if order == "plain" else 50))
        bound_ms, bound_by = bound(*_prefix_work(q, k, None, L))
        res[L] = r = dict(ms=min(times["kernel"]),
                          plain_ms=min(times["plain"]), bound_ms=bound_ms,
                          bound_by=bound_by,
                          library_ms=min(times["library"]))
        print(f"decode_attention at B={B} S={S} length {L} bf16: kernel "
              f"{times['kernel']} ms/call, twin {times['plain']}, "
              f"scaled_dot_product_attention {times['library']} (plain, "
              f"kernel, library, library, kernel, plain); bound "
              f"{bound_ms:.4f} ms ({bound_by}), kernel at "
              f"{bound_ms / r['ms']:.3f} of it, library at "
              f"{bound_ms / r['library_ms']:.3f}")
        del q, k, v, q4, k4, v4
    return res


@torch.inference_mode()
def phase_pallas_main_path(device, B=BATCH, max_new=MAX_NEW):
    """The attn_impl="pallas" path through Generator at its default window
    (256): two same-seed generates, checked, each with exactly n_layer *
    max_new K4 launches and no K1 launch on the card (none of either on
    the CPU, where the twins run). Returns (generator, prompts, K4
    launches per generate)."""
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.ops.decode_attention import (
        decode_attention,
    )
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update

    _, model = _bench_model(device, PALLAS)
    cfg = model.config
    gen = Generator(model, max_new_tokens=max_new, temperature=0.8,
                    top_k=200)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(5),
                            dtype=torch.int32)
    runs = []
    for _ in range(2):
        decode_attention.launches = gqa_decode_update.launches = 0
        out = gen.generate(prompts, seed=1234)
        _sync(device)
        runs.append((out.cpu(), (decode_attention.launches,
                                 gqa_decode_update.launches)))
    (out, launches), (again, launches2) = runs
    if out.shape != (B, PROMPT_LEN + max_new):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT_LEN], prompts):
        raise AssertionError("prompts not preserved")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("token out of range")
    if not torch.equal(out, again):
        raise AssertionError("same seed gave different tokens")
    cuda = torch.device(device).type == "cuda"
    want = (cfg.n_layer * max_new if cuda else 0, 0)
    if not launches == launches2 == want:
        raise AssertionError(f"(K4, K1) launches per generate {launches}, "
                             f"{launches2} != {want}")
    print(f"pallas main path: generate [{B}, {PROMPT_LEN}] -> "
          f"{tuple(out.shape)} at window {gen.window}, prompts kept, tokens "
          f"in range, same seed identical, {launches[0]} K4 launches and "
          f"{launches[1]} K1 launches per generate")
    return gen, prompts, launches[0]


@torch.inference_mode()
def phase_pallas_throughput(gen, prompts):
    """Tokens/s and peak memory of the pallas path (K4) beside the same
    weights with attn_impl="xla" (K1 at MHA bf16), one generate each in the
    order pallas, xla after an xla warm-up (the pallas path is warm from
    its main-path runs). Printed, not gated."""
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig

    device = gen.model.transformer.wte.weight.device
    xla_model = GPT(GPTConfig(**dict(PALLAS, attn_impl="xla")), device=device)
    xla_model.load_state_dict(gen.model.state_dict())
    xla = Generator(xla_model.eval(),
                    max_new_tokens=gen.max_new_tokens, temperature=0.8,
                    top_k=200)
    xla.generate(prompts, seed=99)
    seconds = {"xla": [], "pallas": []}
    peak = {}
    for i, name in enumerate(("pallas", "xla")):
        g = xla if name == "xla" else gen
        torch.cuda.reset_peak_memory_stats()
        seconds[name].append(_event_seconds(
            lambda: g.generate(prompts, seed=3000 + i)))
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    n = prompts.shape[0] * gen.max_new_tokens
    tok_s = {k: n / (sum(v) / len(v)) for k, v in seconds.items()}
    print(f"pallas path at B={prompts.shape[0]}, {gen.max_new_tokens} new "
          f"tokens, window {gen.window}: {tok_s['pallas']:.1f} tok/s "
          f"(generates {seconds['pallas']} s, peak {peak['pallas']:.2f} "
          f"GiB) vs attn_impl=xla (K1) {tok_s['xla']:.1f} tok/s "
          f"({seconds['xla']} s, peak {peak['xla']:.2f} GiB); pallas/xla "
          f"{tok_s['pallas'] / tok_s['xla']:.3f}")
    return tok_s


INT8_VARIANTS = (("decode_attention_int8", 1),
                 ("decode_attention_int8_multirow", 1),
                 ("decode_attention_int8_multirow", 8))


def _int8_call(name, rows, q, k, v, k_scale, v_scale, n, H):
    from ai_music_generation_tpu_torch.ops import decode_attention_int8 as ops

    if name == "decode_attention_int8":
        B, S = k_scale.shape
        return ops.decode_attention_int8(
            q, k, v, k_scale.view(B, 1, S), v_scale.view(B, 1, S), n,
            n_head=H)
    return ops.decode_attention_int8_multirow(q, k, v, k_scale, v_scale, n,
                                              n_head=H, rows_per_program=rows)


def phase_int8_kernel_vs_twin(device, B=BATCH, S=256, H=6, D=64,
                              lengths=(1, 127, 128, 200, 256)):
    """K5 and K6 (R = 1 and 8) against their twin evaluated in fp32 (q
    upcast exactly) at B=4096 and B=16, every column from the length on
    poisoned (int8 127, scales 1e4). Returns the largest error of each."""
    from ai_music_generation_tpu_torch.ops.decode_attention_int8 import (
        decode_attention_int8_reference,
    )

    worst = {name: 0.0 for name, _ in INT8_VARIANTS}
    for b in (B, 16):
        for length in lengths:
            x = _prefix_inputs(b, S, H, D, length, torch.int8, seed=length,
                               device=device)
            ref = decode_attention_int8_reference(x[0].float(), *x[1:],
                                                  n_head=H)
            for name, rows in INT8_VARIANTS:
                out = _int8_call(name, rows, *x, H)
                worst[name] = max(worst[name], _check_close(
                    out, ref, f"{name} R={rows} B={b} length={length}"))
            del x, ref, out
    print(f"int8 decode attention vs twin: K5 and K6 (R 1, 8) at B={B} and "
          f"B=16, S={S}, lengths {list(lengths)}, poisoned past the length: "
          f"finite, max abs err vs the fp32 twin {worst}")
    return worst


def phase_int8_kernel_timing(B=BATCH, S=256, H=6, D=64, L=256):
    """ms per call of K5, K6 (R=8, the JAX default; the kernel launches one
    block per (row, head) whatever R is) and their plain twin at B=4096,
    every column live, in the order plain, K5, K6, K6, K5, plain. No one
    PyTorch call dequantizes a per-position int8 cache, so there is no
    library time. Returns {name: the kernel's JSON numbers}."""
    from ai_music_generation_tpu_torch.ops.decode_attention_int8 import (
        decode_attention_int8_reference,
    )

    x = _prefix_inputs(B, S, H, D, L, torch.int8, seed=8, device="cuda")
    variants = (("decode_attention_int8", 1),
                ("decode_attention_int8_multirow", 8))
    order = [None, *variants, *variants[::-1], None]
    times = {v: [] for v in order}
    for v in order:
        if v is None:
            times[v].append(_cuda_ms(lambda: decode_attention_int8_reference(
                *x, n_head=H), 5))
        else:
            times[v].append(_cuda_ms(lambda: _int8_call(*v, *x, H), 50))
    bound_ms, bound_by = bound(*_prefix_work(x[0], x[1], x[3], L))
    plain_ms = min(times[None])
    res = {}
    for name, rows in variants:
        ms = min(times[(name, rows)])
        print(f"{name} R={rows} at B={B} S={S} length {L} int8: kernel "
              f"{times[(name, rows)]} ms/call, twin {times[None]}; bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it")
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
    return res


def _lean_layer(name, B, S, seed, device):
    """One probe layer of mode ``name`` and its query, made on ``device``
    from a seed (experiments/int4_kernel_probe.py::random_layer): (q, k, v,
    k_scale, v_scale)."""
    from ai_music_generation_tpu_torch.experiments import (
        int4_kernel_probe as probe,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    layer = probe.random_layer(name, B, S, g)
    return (probe.random_query(name, B, g), *layer)


def phase_lean_kernel_vs_twin(device, B=BATCH, S=256):
    """K7 in both modes against its twin evaluated in fp32 on the CPU, at
    B=4096 and B=3, S=256 and S=16: finite and within 2^-6 of the range,
    the room for one p8 (lean8) or bf16-probability (lean4) rounding flip,
    which fp32 sums taken in another order than the twin's can cause at a
    tie (K2's int8_dots yardstick). The CPU twin is the one that
    tests/test_torch_lean_attention.py holds to the JAX kernel. Returns the
    largest error of each mode."""
    from ai_music_generation_tpu_torch.ops.lean_attention import (
        lean_attention, lean_attention_reference,
    )

    worst = {name: 0.0 for name in LEAN_MODES}
    for b in (B, 3):
        for s in (S, 16):
            for name in LEAN_MODES:
                x = _lean_layer(name, b, s, seed=b + s, device=device)
                packed = name == "lean4"
                out = lean_attention(*x, packed)
                ref = lean_attention_reference(*(t.cpu() for t in x), packed)
                worst[name] = max(worst[name], _check_close(
                    out.cpu(), ref, f"lean_attention {name} B={b} S={s}",
                    frac=2.0 ** -6))
                del x, out, ref
    print(f"lean_attention vs twin: lean8 and lean4 at B={B} and B=3, S={S} "
          f"and S=16: finite, max abs err vs the fp32 twin {worst}")
    return worst


def _lean_work(x, name):
    """(bytes, operations, peak rate) of one lean call: reads q, K, V and
    their scales once, writes the fp32 output; QK and PV 2 operations per
    (row, lane, position) each, int8 x int8 in lean8, bf16 in lean4."""
    q, k, v, ks, vs = x
    B, HD = q.shape
    S = ks.shape[-1]
    n = sum(t.nbytes for t in x) + 4 * B * HD
    rate = INT8_OPS_PER_S if name == "lean8" else BF16_OPS_PER_S
    return n, 4 * B * HD * S, rate


def phase_lean_kernel_timing(B=BATCH, S=256):
    """ms per call of K7 in both modes and of their twins at B=4096, S=256,
    in the order plain, lean8, lean4, lean4, lean8, plain (each plain slot
    times both twins). The caches (0.4-0.8 GB) exceed the 50 MB L2, so every
    call reads them from device memory. No one PyTorch call does int8 x
    int8 dots with per-row requantized q and probabilities, or unpacks a
    position-packed int4 cache, so there is no library time. Returns
    {mode: the kernel's JSON numbers}."""
    from ai_music_generation_tpu_torch.ops.lean_attention import (
        lean_attention, lean_attention_reference,
    )

    x = {name: _lean_layer(name, B, S, seed=9, device="cuda")
         for name in LEAN_MODES}
    kernel = {name: [] for name in LEAN_MODES}
    plain = {name: [] for name in LEAN_MODES}
    for slot in ("plain", "lean8", "lean4", "lean4", "lean8", "plain"):
        for name in (LEAN_MODES if slot == "plain" else (slot,)):
            packed = name == "lean4"
            if slot == "plain":
                plain[name].append(_cuda_ms(
                    lambda: lean_attention_reference(*x[name], packed), 5))
            else:
                kernel[name].append(_cuda_ms(
                    lambda: lean_attention(*x[name], packed), 50))
    res = {}
    for name in LEAN_MODES:
        n_bytes, n_ops, rate = _lean_work(x[name], name)
        bound_ms, bound_by = bound(n_bytes, n_ops, rate)
        res[name] = r = dict(ms=min(kernel[name]), plain_ms=min(plain[name]),
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None)
        print(f"lean_attention {name} at B={B} S={S}: kernel {kernel[name]} "
              f"ms/call, twin {plain[name]} (plain, lean8, lean4, lean4, "
              f"lean8, plain); bound {bound_ms:.4f} ms ({bound_by}: "
              f"{n_bytes / 1e6:.1f} MB), {bound_ms / r['ms']:.3f} of it")
    return res


@torch.inference_mode()
def phase_probe_main_path(device, B=BATCH, S=256, iters=3):
    """The probe path through its entry point, ``run_variant``, at full
    width for xla8, lean8 and lean4: each lean step launches K7 once per
    layer (none on the CPU, where the twin runs; none for xla8), and the
    final q is finite. Returns {variant: run_variant's result}."""
    from ai_music_generation_tpu_torch.experiments import (
        int4_kernel_probe as probe,
    )
    from ai_music_generation_tpu_torch.ops.lean_attention import (
        lean_attention,
    )

    cuda = torch.device(device).type == "cuda"
    res = {}
    for name in ("xla8", "lean8", "lean4"):
        before = lean_attention.launches
        r = probe.run_variant(name, batch=B, seq=S, device=device,
                              iters=iters)
        launches = lean_attention.launches - before
        want = probe.L * r["steps"] if cuda and name != "xla8" else 0
        if launches != want:
            raise AssertionError(f"probe {name}: {launches} K7 launches for "
                                 f"{r['steps']} steps, want {want}")
        if not torch.isfinite(r["q"].float()).all():
            raise AssertionError(f"probe {name}: non-finite q")
        ms = r["ms_per_layer"]
        timing = ("not timed" if ms is None else
                  f"{ms:.4f} ms per layer-read, {r['floor_ms'] / ms:.3f} of "
                  f"the floor")
        print(f"probe {name} at B={B} S={S}, {probe.L} layers: {r['steps']} "
              f"steps, {launches} K7 launches, final q finite; floor "
              f"{r['floor_ms']:.4f} ms ({r['floor_bytes'] / 1e6:.1f} MB); "
              f"{timing}")
        res[name] = r
    return res


@torch.inference_mode()
def phase_probe_vs_twin(res, rows=3):
    """One lean8 and one lean4 probe step on a ``rows``-row slice of phase
    15's caches, on their device, against the twin on the CPU applied layer
    by layer to the same inputs (each layer's q as the step saw it: a
    rounding flip in one layer would otherwise carry into the next layer's
    requantized q): within the phase-14 yardstick. Returns the largest
    error."""
    from ai_music_generation_tpu_torch.experiments import (
        int4_kernel_probe as probe,
    )
    from ai_music_generation_tpu_torch.ops.lean_attention import (
        lean_attention_reference,
    )

    worst = 0.0
    for name in LEAN_MODES:
        packed = name == "lean4"
        layers = [tuple(t[:rows].contiguous() for t in layer)
                  for layer in res[name]["layers"]]
        record = []
        q = probe.lean_step(res[name]["q0"][:rows].contiguous(), layers,
                            packed, record=record)
        if not torch.isfinite(q.float()).all():
            raise AssertionError(f"probe {name} slice: non-finite q")
        for i, ((q_in, o), layer) in enumerate(zip(record, layers)):
            ref = lean_attention_reference(
                q_in.cpu(), *(t.cpu() for t in layer), packed)
            worst = max(worst, _check_close(
                o.cpu(), ref, f"probe {name} layer {i}", frac=2.0 ** -6))
    print(f"probe steps on a {rows}-row slice vs the twin, layer by layer: "
          f"max abs err {worst}")
    return worst


def _fp32_decode_inputs(quant, ring, pos, B, S, KH, device):
    """One fp32 decode step's operands on ``device``: the phase-3 inputs
    with q and the slabs (and an unquantized cache) in fp32."""
    x = _decode_inputs(quant, ring, pos, B, S, KH=KH)
    x[0], x[3], x[4] = (t.float() for t in (x[0], x[3], x[4]))
    if not quant:
        x[1], x[2] = x[1].float(), x[2].float()
    return _to(x, device)


def _clone(args):
    return [None if a is None else a.clone() for a in args]


def _fp32_spec_inputs(quant, T, cursor, B, S, H=6, D=64, seed=0,
                      device="cpu", n_live=None):
    """The phase-6 verify operands with a full fp32 q (and an fp32 cache and
    slab when not quantized, full fp32 values too: bf16 ones would leave
    every split part past the first 0)."""
    x = _spec_inputs(quant, T, cursor, B, S, H, D, seed=seed, device=device,
                     n_live=n_live)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    for n in ("q",) if quant else ("q", "k", "v", "k_slab", "v_slab"):
        x[n] = torch.randn(x[n].shape, generator=g, device=device)
    return x


def phase_fp32_kernel_vs_twin(device, B=BATCH, S=WINDOW, spec_S=256, H=6,
                              D=64):
    """K1 and K2 on fp32 operands (an fp32 model's decode and verify steps)
    against their plain twins on the same device and inputs: K1 at B rows,
    S columns and 3 rows over LONG, KH 2 and 6, int8 and fp32 caches,
    lockstep and ring, pos in {0, S-1} (3 rows: {0, 7, S-1}); K2 (with its slab write) at B and
    3 rows (+ a row that reads nothing), S=256, T in {1, 5, 128}, cursors 0
    and S-Tw, int8 and fp32 caches, and at 3 rows (+ the dead row) over
    LONG at T in {5, 17, 64, 65, 128}, the regime edges of phase 6 (a
    refresh there runs 16-query tiles). Caches, scales and the slab write
    bit-exact; the output within FP32_KERNEL_FRAC of its range. Returns the
    largest error of each."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache
    from ai_music_generation_tpu_torch.ops.gqa_decode import (
        gqa_decode_reference, gqa_decode_update,
    )
    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention_reference, spec_attention_update, write_slab,
    )

    worst = {"gqa_decode_update": 0.0, "spec_attention_update": 0.0}
    # B rows at the first and the last position (their inputs are drawn
    # on the host, a second a case), 3 rows also at the tile edge 7
    cases = [(b, s_len, kh, quant, ring, pos)
             for b, s_len in ((B, S), (3, LONG)) for kh in (2, 6)
             for quant in (True, False) for ring in (False, True)
             for pos in ((0, s_len - 1) if b == B else (0, 7, s_len - 1))]
    # cli/sample.py --dtype=float32's decode step (phase 3's CLI cases)
    cases += [(CLI_SAMPLES, CLI_S, 2, True, False, pos)
              for pos in (0, 7, CLI_S - 1)]
    for b, s_len, kh, quant, ring, pos in cases:
        x = _fp32_decode_inputs(quant, ring, pos, b, s_len, kh, device)
        ref_x = _clone(x)
        p = torch.tensor(pos, dtype=torch.int32, device=device)
        out = gqa_decode_update(*x, p)
        ref = gqa_decode_reference(*ref_x, p)
        _sync(device)
        for name, got, want in zip(("k", "v", "k_scale", "v_scale"),
                                   x[1:3] + x[5:7], ref_x[1:3] + ref_x[5:7]):
            if got is not None and not torch.equal(got, want):
                raise AssertionError(
                    f"fp32 K1 {name} differs: B={b} S={s_len} KH={kh} "
                    f"quant={quant} ring={ring} pos={pos}")
        worst["gqa_decode_update"] = max(
            worst["gqa_decode_update"], _check_close(
                out, ref, f"fp32 K1 B={b} S={s_len} KH={kh} quant={quant} "
                f"ring={ring} pos={pos}", FP32_KERNEL_FRAC))
        del x, ref_x, out, ref
    n_spec = 0
    for b, s_len, Ts in ((B, spec_S, (1, 5, 128)), (3, spec_S, (1, 5, 128)),
                         (3, LONG, (5, 17, 64, 65, 128))):
        edges = b == 3
        for T in Ts:
            Tw = -(-T // 8) * 8
            for quant in (True, False):
                for cursor in (0, s_len - Tw):
                    x = _fp32_spec_inputs(quant, T, cursor, b + edges, s_len,
                                          H, D, seed=T + cursor,
                                          device=device)
                    if edges:
                        x["col_pos"][-1] = KVCache.INVALID_POS
                    ref_k, ref_v = x["k"].clone(), x["v"].clone()
                    out = spec_attention_update(*[x[n] for n in SPEC_UPD],
                                                n_head=H)
                    write_slab(ref_k, ref_v, x["k_slab"], x["v_slab"],
                               x["cursor"])
                    ref = spec_attention_reference(
                        x["q"], ref_k, ref_v, *[x[n] for n in SPEC_ATT[3:]],
                        n_head=H)
                    _sync(device)
                    if not (torch.equal(x["k"], ref_k)
                            and torch.equal(x["v"], ref_v)):
                        raise AssertionError(
                            f"fp32 K2 write differs: B={b} S={s_len} T={T} "
                            f"cursor={cursor} quant={quant}")
                    if edges:  # the dead row: 0 from the kernel, NaN in
                        # the twin (which is what runs on the CPU)
                        if torch.device(device).type == "cuda" and not \
                                torch.equal(out[-1], torch.zeros_like(out[-1])):
                            raise AssertionError(f"fp32 K2 dead row not 0: "
                                                 f"S={s_len} T={T} "
                                                 f"quant={quant}")
                        out, ref = out[:-1], ref[:-1]
                    worst["spec_attention_update"] = max(
                        worst["spec_attention_update"], _check_close(
                            out, ref, f"fp32 K2 B={b} S={s_len} T={T} "
                            f"cursor={cursor} quant={quant}",
                            FP32_KERNEL_FRAC))
                    n_spec += 1
                    del x, ref_k, ref_v, out, ref
    print(f"fp32 kernels vs twin: K1 {len(cases)} cases (B={B}, S={S} and "
          f"B=3, S={LONG}; KH 2, 6; int8 and fp32 caches; lockstep and "
          f"ring; pos 0, (7,) S-1; and B={CLI_SAMPLES}, S={CLI_S}, KH 2 int8 "
          f"lockstep), K2 {n_spec} cases (B={B} and B=3 + a dead "
          f"row, S={spec_S}, T 1, 5, 128; B=3 + a dead row, S={LONG}, T 5, "
          f"17, 64, 65, 128; cursors 0 and S-Tw, int8 and fp32 caches, full "
          f"fp32 operands): caches, scales and writes bit-exact; out max abs "
          f"err "
          f"{worst} (within {FP32_KERNEL_FRAC} of the range)")
    return worst


def _timed(kernel_fn, plain_fn, k_iters, p_iters):
    """(kernel ms list, plain ms list) in the order plain, kernel, kernel,
    plain."""
    kernel, plain = [], []
    for order in (0, 1, 1, 0):
        if order:
            kernel.append(_cuda_ms(kernel_fn, k_iters))
        else:
            plain.append(_cuda_ms(plain_fn, p_iters))
    return kernel, plain


def _k1_work(x, S, ops_per_s):
    """(bound ms, bound by) of one K1 call: reads q, the S-1 older columns
    of K and V (and their scales), the slabs (and the ring mask); writes
    the fresh column of K and V (and its scales) and out. QK and PV two
    operations per (query head, position, lane) each."""
    q, k, _, k_slab, _, k_scale, _, mask_rel = x
    B, KHD = k.shape[0], k.shape[2]
    item = k.element_size()
    n = (2 * q.nbytes + 2 * B * (S - 1) * KHD * item + 2 * k_slab.nbytes
         + 2 * B * KHD * item)
    if k_scale is not None:
        n += 2 * 2 * B * k_scale.shape[1] * S
    if mask_rel is not None:
        n += mask_rel.nbytes
    return bound(n, 4 * q.numel() * S, ops_per_s)


def _f32_spec_bound(x, T, n_live, H, write):
    """(bound ms, bound by) of one fp32 K2/K3 call: the bytes of
    ``_spec_work``, its operations as the split passes that the tensor-core
    kernel runs, two fp16 passes per product over an int8 cache at 989
    TFLOP/s, three TF32 passes over an fp32 one at 495."""
    n_bytes, n_ops = _spec_work(x, T, n_live, H, write)
    if x["k_scale"] is not None:
        return bound(n_bytes, 2 * n_ops, BF16_OPS_PER_S)
    return bound(n_bytes, 3 * n_ops, TF32_OPS_PER_S)


def phase_fp32_kernel_timing(B=BATCH, S=WINDOW, spec_S=256, H=6, D=64,
                             serve_B=SERVE_SLOTS, cli_B=CLI_SPEC_SAMPLES):
    """ms per call of the fp32 kernels and their twins on the card (plain,
    kernel, kernel, plain): K1 fp32 at the bench decode shape (int8 cache,
    lockstep, pos S-1); K2 fp32 at a verify step (T=5, every history column
    live) and a refresh (T=128 at cursor 0), int8 cache, and at the
    sampling CLI's verify step (B=64); K3 fp32 at the verify step over the
    int8 cache and over an fp32 one, the latter beside fp32
    ``scaled_dot_product_attention`` under the col_pos mask (plain,
    library, kernel, kernel, library, plain); and K1 in ring mode at the
    serving tick's shape (bf16 q, B=8192 slots, S=128, int8, every row at
    a random length). Each is first held against its twin on copies of the
    same inputs (caches, scales and writes bit-exact, the output within the
    yardstick of its type). No one PyTorch call fuses K1's or K2's writes
    with the attention, so they have no library time. The fp32 K2/K3 bound
    counts their split passes on the tensor cores (``_f32_spec_bound``);
    the CUDA-core bound of fp32 operations at 67 TFLOP/s is printed beside
    it. Returns {name: the kernel's JSON numbers}."""
    import torch.nn.functional as F

    from ai_music_generation_tpu_torch.ops.gqa_decode import (
        gqa_decode_reference, gqa_decode_update,
    )
    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention, spec_attention_reference, spec_attention_update,
        write_slab,
    )

    res = {}
    pos = torch.tensor(S - 1, dtype=torch.int32, device="cuda")
    for label, x, ops in (
            ("k1_fp32", _fp32_decode_inputs(True, False, S - 1, B, S, 2,
                                            "cuda"), FP32_OPS_PER_S),
            ("k1_ring", _to(_decode_inputs(True, True, S - 1, serve_B, S),
                            "cuda"), BF16_OPS_PER_S)):
        # first the kernel against its twin on copies of the same inputs:
        # caches and scales bit-exact, the output within the kernel's
        # yardstick (fp32: FP32_KERNEL_FRAC of the twin; bf16: one bf16 ulp
        # of the range of the twin evaluated in fp32, as in phase 3)
        kx, rx = _clone(x), _clone(x)
        out = gqa_decode_update(*kx, pos)
        ref = gqa_decode_reference(*rx, pos)
        fp32 = x[0].dtype == torch.float32
        if not fp32:
            ref = gqa_decode_reference(*_upcast(x), pos)
        for name, got, want in zip(("k", "v", "k_scale", "v_scale"),
                                   kx[1:3] + kx[5:7], rx[1:3] + rx[5:7]):
            if not torch.equal(got, want):
                raise AssertionError(f"gqa_decode {label}: {name} differs")
        err = _check_close(out, ref, f"gqa_decode {label}",
                           FP32_KERNEL_FRAC if fp32 else 2.0 ** -7)
        del kx, rx, out, ref
        kernel, plain = _timed(lambda: gqa_decode_update(*x, pos),
                               lambda: gqa_decode_reference(*x, pos), 50, 10)
        bound_ms, bound_by = _k1_work(x, S, ops)
        res[label] = r = dict(ms=min(kernel), plain_ms=min(plain),
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None, max_abs_err=err)
        print(f"gqa_decode {label} at B={x[0].shape[0]} S={S} int8 "
              f"({x[0].dtype}): caches and scales bit-exact with the twin, "
              f"out max abs err {err}; kernel {kernel} ms/call, twin {plain} "
              f"(plain, kernel, kernel, plain); bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / r['ms']:.3f} of it")
        del x

    def plain_update(x):
        write_slab(x["k"], x["v"], x["k_slab"], x["v_slab"], x["cursor"])
        return spec_attention_reference(*[x[n] for n in SPEC_ATT], n_head=H)

    def report(label, what, x, T, n_live, write, kernel, plain, err,
               library=None):
        bound_ms, bound_by = _f32_spec_bound(x, T, n_live, H, write)
        core_ms, core_by = bound(*_spec_work(x, T, n_live, H, write),
                                 FP32_OPS_PER_S)
        res[label] = r = dict(ms=min(kernel), plain_ms=min(plain),
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=min(library) if library else None,
                              max_abs_err=err, cuda_core_bound_ms=core_ms)
        print(f"{what} (B={x['q'].shape[0]} S={x['k'].shape[1]} T={T} "
              f"{'int8' if x['k_scale'] is not None else 'fp32'} cache, "
              f"fp32 q, {n_live} live history columns): out max abs err "
              f"{err}; kernel {kernel} ms/call, twin {plain}"
              + (f", scaled_dot_product_attention {library}"
                 if library else "")
              + f"; bound {bound_ms:.4f} ms ({bound_by}, split passes on "
              f"the tensor cores), {bound_ms / r['ms']:.3f} of it; CUDA-core "
              f"bound {core_ms:.4f} ms ({core_by})")

    for label, b, T, cursor, n_live in (
            ("k2_fp32", B, 5, spec_S - 8, spec_S - 8),
            ("k2_fp32_refresh", B, 128, 0, 0),
            ("k2_fp32_cli", cli_B, 5, spec_S - 8, spec_S - 8)):
        x = _fp32_spec_inputs(True, T, cursor, b, spec_S, H, D, seed=1,
                              device="cuda", n_live=n_live)
        kx, rx = ({n: t.clone() if torch.is_tensor(t) else t
                   for n, t in x.items()} for _ in range(2))
        out = spec_attention_update(*[kx[n] for n in SPEC_UPD], n_head=H)
        ref = plain_update(rx)
        if not (torch.equal(kx["k"], rx["k"]) and torch.equal(kx["v"],
                                                              rx["v"])):
            raise AssertionError(f"spec_attention_update {label}: the write "
                                 "differs")
        err = _check_close(out, ref, f"spec_attention_update {label}",
                           FP32_KERNEL_FRAC)
        del kx, rx, out, ref
        kernel, plain = _timed(
            lambda: spec_attention_update(*[x[n] for n in SPEC_UPD],
                                          n_head=H),
            lambda: plain_update(x), 10 if b == B else 200, 3)
        report(label, f"spec_attention_update {label}", x, T, n_live, True,
               kernel, plain, err)
        del x

    T, cursor, n_live = 5, spec_S - 8, spec_S - 8
    for quant in (True, False):
        x = _fp32_spec_inputs(quant, T, cursor, B, spec_S, H, D, seed=1,
                              device="cuda", n_live=n_live)
        att = [x[n] for n in SPEC_ATT]
        err = _check_close(spec_attention(*att, n_head=H),
                           spec_attention_reference(*att, n_head=H),
                           "spec_attention fp32", FP32_KERNEL_FRAC)
        lib_call = None
        if not quant:  # the same function as one PyTorch call
            qv, kv, vv = (x[n].view(B, -1, H, D).transpose(1, 2)
                          for n in ("q", "k", "v"))
            mask = (x["col_pos"][:, None, None, :] <= (
                x["lengths"][:, None] + torch.arange(
                    T, device="cuda"))[:, None, :, None])
            lib_call = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qv, kv, vv, attn_mask=mask)
            lib_err = (lib_call().transpose(1, 2).reshape(B, T, -1)
                       - spec_attention_reference(*att, n_head=H)).abs().max()
            print(f"scaled_dot_product_attention fp32 vs the fp32 twin: max "
                  f"abs err {lib_err.item()}")
        k3, p3, lib = [], [], []
        for order in ("plain", "library", "kernel", "kernel", "library",
                      "plain"):
            if order == "plain":
                p3.append(_cuda_ms(lambda: spec_attention_reference(
                    *att, n_head=H), 3))
            elif order == "kernel":
                k3.append(_cuda_ms(lambda: spec_attention(*att, n_head=H),
                                   20))
            elif lib_call is not None:
                lib.append(_cuda_ms(lib_call, 20))
        label = "k3_fp32" if quant else "k3_fp32_cache"
        report(label, f"spec_attention {label}", x, T, n_live, False, k3, p3,
               err, lib)
        del x, att, lib_call
    return res


@torch.inference_mode()
def phase_fp32_models(device, B=BATCH, rows=8, steps=16, verify_steps=4):
    """The bench widths at fp32 on the card against the CPU: flat_kv KH=2
    int8 (K1 fp32 over int8), MHA with an fp32 cache (K1 fp32 over fp32),
    and the spec MHA model with its int8 cache (the fp32 K2): logits within
    FP32_MODEL_FRAC of their range, FP32_INT8_MODEL_FRAC with an int8
    cache."""
    phase_model(device, B, rows, steps, config=FP32_BENCH,
                frac=FP32_INT8_MODEL_FRAC)
    phase_model(device, B, rows, steps, config=FP32_MHA, window=None,
                frac=FP32_MODEL_FRAC)
    phase_spec_model(device, B, rows, verify_steps, config=FP32_SPEC,
                     frac=FP32_INT8_MODEL_FRAC)


@torch.inference_mode()
def phase_fp32_generator(device, B=64, max_new=100):
    """A greedy fp32 Generator (FP32_BENCH, window 128) at B rows: shape,
    prompts kept, tokens in range; on the card exactly n_layer K1 launches
    per step and not one call of the twin. Returns the K1 launches."""
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.ops import gqa_decode as ops

    _, model = _bench_model(device, FP32_BENCH)
    prompts = torch.randint(0, model.config.vocab_size, (B, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(8),
                            dtype=torch.int32)
    twin, calls = ops.gqa_decode_reference, []

    def counted(*args):
        calls.append(1)
        return twin(*args)

    ops.gqa_decode_reference = counted
    try:
        before = ops.gqa_decode_update.launches
        out = Generator(model, max_new_tokens=max_new, temperature=0.0,
                        top_k=None, window=WINDOW).generate(prompts).cpu()
        launches = ops.gqa_decode_update.launches - before
    finally:
        ops.gqa_decode_reference = twin
    cuda = torch.device(device).type == "cuda"
    want = (model.config.n_layer * max_new, 0) if cuda else (0, len(calls))
    if (launches, len(calls)) != want or (cuda and calls):
        raise AssertionError(f"fp32 Generator: {launches} K1 launches and "
                             f"{len(calls)} twin calls, want {want}")
    if out.shape != (B, PROMPT_LEN + max_new) or not torch.equal(
            out[:, :PROMPT_LEN], prompts):
        raise AssertionError("fp32 Generator: shape or prompts")
    if not ((out >= 0) & (out < model.config.vocab_size)).all():
        raise AssertionError("fp32 Generator: token out of range")
    print(f"fp32 Generator (greedy, B={B}, {max_new} new tokens): "
          f"{launches} K1 launches = n_layer x steps, {len(calls)} twin calls")
    return launches


def _serve_requests(ctxs):
    from ai_music_generation_tpu_torch.serve.engine import Request

    return [(i, Request(id=i, prompt=c, max_new_tokens=1 << 30,
                        temperature=0.0, top_k=1, seed=0, stop_token=-1), c,
             0) for i, c in enumerate(ctxs)]


@torch.inference_mode()
def phase_serve_model(device, rows=8, n_slots=SERVE_SLOTS, chunk=48):
    """The bench model in ring mode (the serving cache, cache_len 128) on
    the card (``n_slots`` slots) against the CPU (``rows`` slots): rows at
    staggered prompt lengths (4-46) admitted into slots 0.. by the engine's
    insert-prefill (lockstep prefill, roll to the cursor, scatter), then
    3 x ``chunk`` teacher-forced ticks with a window refresh (re-admission of
    the last 64 tokens, rolled to the cursor where it stands) between
    chunks, so the cursor wraps; idle slots pinned as the engine pins them.
    Logits within the phase-4 yardstick (2^-4 of the range) and exactly
    n_layer K1 launches per tick (none on the CPU)."""
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update
    from ai_music_generation_tpu_torch.serve.engine import GenerationServer

    cpu_model, model = _bench_model(device)
    kw = dict(ticks_per_call=chunk, cache_len=SERVE_CACHE,
              admit_group=SERVE_GROUP)
    srvs = (GenerationServer(model, n_slots=n_slots, **kw),
            GenerationServer(cpu_model, n_slots=rows, **kw))
    V = model.config.vocab_size
    g = torch.Generator().manual_seed(7)
    hist = [torch.randint(0, V, (4 + 6 * i,), generator=g).tolist()
            for i in range(rows)]
    worst = tol = 0.0
    ticks, before = 0, gqa_decode_update.launches
    for c in range(3):
        for srv in srvs:  # admission, then a refresh before each chunk
            srv._admit_wave(_serve_requests(hist))
        for _ in range(chunk):
            ids = torch.randint(0, V, (rows,), generator=g, dtype=torch.int32)
            logits = []
            for srv in srvs:
                tok = torch.zeros(srv.n_slots, dtype=torch.int32,
                                  device=srv.device)
                tok[:rows] = ids.to(srv.device)
                out, _ = srv.model(tok[:, None], cache=srv.cache)
                srv.cache.length -= (~srv.active).to(torch.int32)
                logits.append(out[:rows, 0].float().cpu())
            for h, i in zip(hist, ids.tolist()):
                h.append(i)
            if not torch.isfinite(logits[0]).all():
                raise AssertionError("non-finite serving logits on the card")
            err = (logits[0] - logits[1]).abs().max().item()
            tol = max(tol, 2.0 ** -4 * logits[1].abs().max().item())
            if not err <= tol:
                raise AssertionError(f"serving logits differ by {err} > {tol}"
                                     f" at tick {ticks}")
            worst = max(worst, err)
            ticks += 1
    launches = gqa_decode_update.launches - before
    cuda = torch.device(device).type == "cuda"
    want = model.config.n_layer * ticks if cuda else 0
    cursors = [int(srv.cache.cursor) for srv in srvs]
    if launches != want or cursors != [ticks % SERVE_CACHE] * 2 \
            or ticks <= SERVE_CACHE:
        raise AssertionError(f"serving model: {launches} K1 launches (want "
                             f"{want}), cursors {cursors} after {ticks} ticks")
    print(f"serving model (ring, cache_len {SERVE_CACHE}, {n_slots} slots on "
          f"the card): {rows} rows at prompt lengths 4-{4 + 6 * (rows - 1)}, "
          f"3 admissions, {ticks} ticks (the cursor wrapped): logits max abs"
          f" err {worst} (tol {tol}); {launches} K1 launches = n_layer x "
          f"ticks")


@torch.inference_mode()
def phase_serve_main_path(device, n_slots=SERVE_SLOTS,
                          requests=SERVE_REQUESTS, max_new=SERVE_MAX_NEW):
    """The serving main path through cli/serve_bench.py's load on one
    long-lived GenerationServer (SERVE_* settings): a cold pass, then a
    differently seeded hot pass. Every request finishes with its budget,
    every token is in range, K1 launches = n_layer x ticks run (ticks
    counted by a hook on the model's T=1 calls); the hot pass's first
    request re-run alone in slot 0 and alone in another slot (slot 1,
    behind a filler) gives identical tokens; the counter noise is bit-equal
    on the card and the CPU. Whether the re-run also gives the hot pass's
    tokens is printed, not gated: there the request's prefills ran in
    512-row waves, alone in 8-row ones, and cuBLAS may choose another
    algorithm (and round otherwise) for another shape. Prints tok/s, the
    latency percentiles and the step phases. Returns (tok/s, latency,
    stats, K1 launches)."""
    from ai_music_generation_tpu_torch.cli import serve_bench
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update
    from ai_music_generation_tpu_torch.serve.engine import (
        GenerationServer, noise_bits,
    )

    _, model = _bench_model(device)
    V = model.config.vocab_size
    srv = GenerationServer(model, n_slots=n_slots, ticks_per_call=SERVE_TICKS,
                           admit_group=SERVE_GROUP, cache_len=SERVE_CACHE)
    ticks = []
    handle = model.register_forward_pre_hook(
        lambda _, args: ticks.append(1) if args[0].shape[1] == 1 else None)
    before = gqa_decode_update.launches
    try:
        _, cold = serve_bench.run_pass(srv, requests, max_new, 1338)
        srv.reset_stats()
        finished, wall = serve_bench.run_pass(srv, requests, max_new, 1337)
        stats, latency = dict(srv.stats), srv.latency_stats()
        launches = gqa_decode_update.launches - before
        n_ticks = len(ticks)
        first = min(finished, key=lambda r: r.id)
        kw = dict(max_new_tokens=first.max_new_tokens,
                  temperature=first.temperature, top_k=first.top_k,
                  seed=first.seed, top_p=first.top_p)
        reruns = []
        for filler in (False, True):  # alone in slot 0, then in slot 1
            if filler:
                srv.submit([1], max_new_tokens=1, temperature=0.0)
            rid = srv.submit(first.prompt, **kw)
            reruns.append({r.id: r for r in srv.run_until_idle()}[rid])
    finally:
        handle.remove()
    if len(finished) != requests or any(
            len(r.generated) != r.max_new_tokens for r in finished):
        raise AssertionError("a request did not finish with its budget")
    if any(t < 0 or t >= V for r in finished for t in r.generated):
        raise AssertionError("serving token out of range")
    cuda = torch.device(device).type == "cuda"
    if launches != (model.config.n_layer * n_ticks if cuda else 0):
        raise AssertionError(f"{launches} K1 launches for {n_ticks} ticks")
    alone, behind = (r.generated for r in reruns)
    if alone != behind:
        raise AssertionError("a request re-run alone gave other tokens in "
                             "another slot")
    same = next((i for i, (a, b) in enumerate(zip(alone, first.generated))
                 if a != b), len(alone))
    g = torch.Generator().manual_seed(9)
    seed = torch.randint(0, 2**32, (4096,), generator=g, dtype=torch.int64)
    gen = torch.randint(0, 1 << 20, (4096,), generator=g, dtype=torch.int32)
    if not torch.equal(noise_bits(seed.to(device), gen.to(device), V).cpu(),
                       noise_bits(seed, gen, V)):
        raise AssertionError("counter noise differs between the card and "
                             "the CPU")
    gen_tokens = sum(len(r.generated) for r in finished)
    tok_s = gen_tokens / wall
    print(f"serving main path: {n_slots} slots, cache_len {SERVE_CACHE}, "
          f"admit_group {SERVE_GROUP}, {SERVE_TICKS} ticks a call; cold pass "
          f"{cold:.3f} s, hot pass {requests} requests, {gen_tokens} tokens "
          f"in {wall:.3f} s = {tok_s:.1f} tok/s; every request finished "
          f"with its budget, tokens in range; {launches} K1 launches = "
          f"n_layer x {n_ticks} ticks; a request re-run alone in slots 0 and"
          f" 1 identical, equal to its hot-pass tokens for {same} of "
          f"{len(alone)}; counter noise bit-equal card vs CPU")
    print(f"serving latency {latency}; phases {stats}")
    return tok_s, latency, stats, launches


def _cli_workspace(root, n_val=CLI_SAMPLES):
    """The real-path corpus (docs/experiments/realpath_bench_r5.py:49-68:
    random ABC tunes, char-prepared as dataset irishman) with ``n_val``
    validation tunes, and ckpt.pt files of init weights at the bench
    widths (vocabulary: the corpus's) for a GQA KH=2 and an MHA model.
    Returns (data_root, validation JSON, {name: out_dir}, small validation
    JSON of CLI_SPEC_SAMPLES tunes)."""
    import contextlib
    import io
    import os

    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )
    from ai_music_generation_tpu_torch.data.prepare import prepare_char
    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
    from ai_music_generation_tpu_torch.models.nanogpt_ckpt import save_ckpt

    tunes = random_tunes(2700 + n_val, seed=7)
    entries = [{"abc notation": t} for t in tunes]
    data_root = os.path.join(root, "data")
    with contextlib.redirect_stdout(io.StringIO()):
        vocab, _, _ = prepare_char(entries[:2700], entries[2700:],
                                   os.path.join(data_root, "irishman"))
    val = [{"id": i, "abc notation": t} for i, t in enumerate(tunes[2700:])]
    paths = []
    for name, rows in (("validation.json", val),
                       ("validation_small.json", val[:CLI_SPEC_SAMPLES])):
        paths.append(os.path.join(root, name))
        with open(paths[-1], "w") as f:
            json.dump(rows, f)
    out = {}
    for name, kh in (("gqa", 2), ("mha", None)):
        cfg = GPTConfig(**dict(BENCH, vocab_size=vocab, n_kv_head=kh))
        model = init_weights(GPT(cfg, device="cpu"),
                             torch.Generator().manual_seed(0))
        out[name] = os.path.join(root, name)
        os.makedirs(out[name])
        save_ckpt(os.path.join(out[name], "ckpt.pt"), model,
                  train_config={"dataset": "irishman"})
    return data_root, paths[0], out, paths[1]


def phase_http(ws, device, n_slots=256):
    """cli/serve.py's HTTP server over the GQA checkpoint on 127.0.0.1 (a
    free port) in a thread: two identical seeded /generate requests (text
    prompt) give the same tokens and a text of one character a token, a
    streamed one gives chunks whose concatenation is its final answer, a
    request that fills its window at the default cache_len finishes beside
    a longer one, /health reports the slots and the finished requests."""
    import threading
    import urllib.request

    from ai_music_generation_tpu_torch.cli import serve as serve_cli

    data_root, _, out, _ = ws
    c = dict(serve_cli.DEFAULTS, out_dir=out["gqa"], data_root=data_root,
             tokens_format="char", port=0, n_slots=n_slots, ticks_per_call=32,
             admit_group=64, kv_quantized=True, flat_kv=True, device=device)
    runner, httpd = serve_cli.build_server(c)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def post(body):
        req = urllib.request.Request(f"{url}/generate",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type":
                                              "application/json"})
        return urllib.request.urlopen(req, timeout=300)

    try:
        body = {"prompt": "X:1\nL:1/8\nM:3/4\nK:G\n", "max_new_tokens": 64,
                "seed": 5}
        answers = []
        for _ in range(2):
            with post(body) as r:
                answers.append(json.loads(r.read()))
        if answers[0]["tokens"] != answers[1]["tokens"] or len(
                answers[0]["tokens"]) != 64 or len(answers[0]["text"]) != 64:
            raise AssertionError(f"/generate answers {answers}")
        with post({"tokens": [1, 2, 3], "max_new_tokens": 96, "seed": 6,
                   "stream": True}) as r:
            events = [json.loads(line[6:]) for line in r
                      if line.startswith(b"data: ")]
        streamed = [t for ev in events[:-1] for t in ev["tokens"]]
        if not events[-1].get("done") or streamed != events[-1]["tokens"] \
                or len(streamed) != 96 or len(events) < 4:
            raise AssertionError(f"SSE stream: {len(events)} events")
        # at the CLI's default cache_len (block_size; refresh 128, 32 ticks
        # a call) a 128-token context with 128 new tokens passes length 224
        # without a refresh and finishes idle at length block_size while a
        # later request keeps ticking
        full = {}
        thread_a = threading.Thread(target=lambda: full.update(a=json.loads(
            post({"tokens": [1, 2, 3] * 60, "max_new_tokens": 128,
                  "seed": 7}).read())))
        thread_a.start()
        with post({"tokens": [1, 2, 3], "max_new_tokens": 192,
                   "seed": 8}) as r:
            full["b"] = json.loads(r.read())
        thread_a.join(timeout=300)
        if [len(full.get(k, {}).get("tokens", ())) for k in "ab"] \
                != [128, 192]:
            raise AssertionError("a request that filled its window, or the "
                                 "one beside it, did not finish")
        with urllib.request.urlopen(f"{url}/health", timeout=60) as r:
            health = json.loads(r.read())
        if health["slots"] != n_slots or health["latency"]["count"] != 5 \
                or "engine_error" in health:
            raise AssertionError(f"/health {health}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.shutdown()
        thread.join(timeout=30)
    print(f"HTTP (cli/serve.py, {n_slots} slots, cache_len block_size): two"
          f" seeded /generate answers identical (64 tokens), SSE "
          f"{len(events)} events = the 96-token answer, a request that "
          f"filled its window and one beside it finished (128 and 192 "
          f"tokens), /health {health['slots']} slots, latency "
          f"{health['latency']}")


def _sample_files(out_dir):
    import os

    d = os.path.join(out_dir, "samples")
    files = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            files[name] = f.read()
    return files


@torch.inference_mode()
def phase_sample_cli(ws, device, samples=CLI_SAMPLES, new=CLI_NEW):
    """cli/sample.py's main at the real-path protocol over the GQA
    checkpoint with --kv_quantized --flat_kv, twice at one seed (identical
    files), then at --dtype=float32, then --speculative over the MHA
    checkpoint (fp32, CLI_SPEC_SAMPLES tunes). Every run writes one
    sample_<id>.abc per validation tune, each starting with its X:<id>
    header. Prints samples/s and tok/s of each whole run (load, decode,
    files). Returns {run: (K1 launches, K2 launches, samples/s)}."""
    import shutil

    from ai_music_generation_tpu_torch.cli import sample as cli
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update
    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention_update,
    )

    data_root, val, out, val_small = ws
    base = [f"--data_root={data_root}", "--dataset=irishman",
            "--tokens_format=char", "--n_conditional_measures=4",
            f"--max_new_tokens={new}", "--temperature=0.8", "--top_k=200",
            "--seed=1337", "--kv_quantized=True", f"--device={device}"]
    runs = (("bf16", out["gqa"], val, samples, ["--flat_kv=True"]),
            ("bf16 again", out["gqa"], val, samples, ["--flat_kv=True"]),
            ("fp32", out["gqa"], val, samples,
             ["--flat_kv=True", "--dtype=float32"]),
            ("speculative fp32", out["mha"], val_small, CLI_SPEC_SAMPLES,
             ["--speculative=True", "--dtype=float32"]))
    res, files = {}, {}
    for name, out_dir, val_path, n, extra in runs:
        shutil.rmtree(f"{out_dir}/samples", ignore_errors=True)
        k1, k2 = gqa_decode_update.launches, spec_attention_update.launches
        t0 = time.perf_counter()
        cli.main(base + [f"--out_dir={out_dir}", f"--validation_path="
                         f"{val_path}", f"--batch_size={n}"] + extra)
        wall = time.perf_counter() - t0
        files[name] = _sample_files(out_dir)
        if sorted(files[name]) != sorted(f"sample_{i}.abc"
                                         for i in range(n)):
            raise AssertionError(f"sample CLI {name}: files "
                                 f"{sorted(files[name])[:3]}...")
        bad = [f for f, text in files[name].items()
               if not text.startswith(f"X:{f[7:-4]}\n")]
        if bad:
            raise AssertionError(f"sample CLI {name}: no X: header in {bad[:3]}")
        res[name] = (gqa_decode_update.launches - k1,
                     spec_attention_update.launches - k2, n / wall)
        print(f"sample CLI {name}: {n} samples x {new} new tokens in "
              f"{wall:.3f} s = {n / wall:.1f} samples/s, "
              f"{n * new / wall:.1f} tok/s; K1 {res[name][0]} and K2 "
              f"{res[name][1]} launches")
    if files["bf16"] != files["bf16 again"]:
        raise AssertionError("sample CLI: the same seed gave other files")
    cuda = torch.device(device).type == "cuda"
    if cuda and not (res["bf16"][0] and res["fp32"][0]
                     and res["speculative fp32"][1]):
        raise AssertionError(f"sample CLI runs missed a kernel: {res}")
    print("sample CLI: file names and X: headers as the JAX CLI writes "
          "them; the same seed gave identical files")
    return res


def _music_arch(data_root) -> tuple[dict, dict]:
    """(the music config's trainer config, its model_args on the corpus
    under ``data_root``)."""
    import os

    from ai_music_generation_tpu_torch.data.memmap import load_meta
    from ai_music_generation_tpu_torch.train.trainer import (
        ARCH_KEYS,
        DEFAULTS,
    )
    from ai_music_generation_tpu_torch.utils.configurator import (
        apply_overrides,
    )

    c = apply_overrides(DEFAULTS, [MUSIC_CONFIG])
    meta = load_meta(os.path.join(data_root, c["dataset"], "meta.pkl"))
    c["vocab_size"] = meta["vocab_size"]
    return c, {k: c[k] for k in ARCH_KEYS}


def phase_train_step(ws, device, B=4, accum=2) -> dict:
    """One train step (train/step.py: accum 2 of batch 4, AdamW, the clip)
    of the music config on ``device`` against the CPU from the same init
    weights and batch, at fp32 and bf16, dropout 0: loss and grad_norm
    within TRAIN_STEP_FRAC of their value, every parameter within it of the
    parameters' range. The step index is the end of the warmup (lr 1e-3),
    so the update is not a rounding of nothing. Then at dropout 0.2: the
    masks of layer 0 at its four sites bit-equal card vs CPU, and one fp32
    step with them within the fp32 yardstick. Returns each error as a
    share of its yardstick's scale."""
    import os

    from ai_music_generation_tpu_torch.data.memmap import BinDataset
    from ai_music_generation_tpu_torch.models import gpt
    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.train.optimizer import (
        cosine_warmup_schedule,
        make_optimizer,
    )
    from ai_music_generation_tpu_torch.train.step import make_train_step

    c, arch = _music_arch(ws[0])
    T = c["block_size"]
    ds = BinDataset(os.path.join(ws[0], c["dataset"], "train.bin"))
    x, y = (torch.from_numpy(a) for a in ds.sample(c["seed"], 0, (accum, B),
                                                   T))
    it = c["warmup_iters"]
    schedule = cosine_warmup_schedule(c["learning_rate"], c["warmup_iters"],
                                      c["lr_decay_iters"], c["min_lr"])
    errs = {}
    for name, dtype, dropout in (("fp32", torch.float32, 0.0),
                                 ("bf16", torch.bfloat16, 0.0),
                                 ("fp32 dropout", torch.float32,
                                  c["dropout"])):
        cfg = gpt.GPTConfig(**arch, dtype=dtype, dropout=dropout)
        cpu = init_weights(gpt.GPT(cfg, device="cpu"),
                           torch.Generator().manual_seed(0))
        models = (cpu, copy.deepcopy(cpu).to(device))
        metrics = []
        for m in models:
            dev = m.lm_head.weight.device
            step = make_train_step(m, make_optimizer(
                m, c["learning_rate"], c["weight_decay"], c["beta1"],
                c["beta2"]), schedule, c["grad_clip"])
            metrics.append(step(x.to(dev), y.to(dev), it, c["seed"]))
        frac = TRAIN_STEP_FRAC[dtype]
        err = {key: abs(float(metrics[1][key]) - float(metrics[0][key]))
               / abs(float(metrics[0][key])) for key in ("loss", "grad_norm")}
        ref = models[0].state_dict()
        span = max(float(v.abs().max()) for v in ref.values())
        err["params"] = max(float((v.cpu() - ref[k]).abs().max())
                            for k, v in models[1].state_dict().items()) / span
        print(f"train step {name} ({device} vs cpu, accum {accum} x batch "
              f"{B}, T {T}): loss {float(metrics[1]['loss']):.6f} vs "
              f"{float(metrics[0]['loss']):.6f}; errors "
              + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
              + f" (yardstick {frac:.3g})")
        if not all(v <= frac for v in err.values()):
            raise AssertionError(f"train step {name}: {err} over {frac}")
        errs[name] = max(err.values())
    key = gpt.dropout_key(c["seed"], it, 0)
    C, H = arch["n_embd"], arch["n_head"]
    shapes = {gpt.SITE_EMBED: (B, T, C), gpt.SITE_ATTN_PROBS: (B, H, T, T),
              gpt.SITE_ATTN_OUT: (B, T, C), gpt.SITE_MLP_OUT: (B, T, C)}
    kept = {}
    for site, shape in shapes.items():
        card = gpt.dropout_keep(shape, c["dropout"], key, 0, site, device)
        if not torch.equal(card.cpu(), gpt.dropout_keep(shape, c["dropout"],
                                                        key, 0, site)):
            raise AssertionError(f"dropout site {site}: card != CPU")
        kept[site] = float(card.float().mean())
    print(f"dropout masks of layer 0 (p {c['dropout']}) bit-equal card vs "
          f"CPU at its four sites; kept shares {kept}")
    return errs


def _dropout_vs_twin(x, up, p, key, layer, site, twin_device) -> None:
    """The kernel's forward and backward at one site (``x`` on the card,
    upstream gradient ``up``) bit-equal to the plain twin's on
    ``twin_device``, in 2 launches."""
    from ai_music_generation_tpu_torch.ops.dropout import (
        CounterDropout, dropout_apply, dropout_reference,
    )

    a = x.detach().clone().requires_grad_()
    b = x.detach().to(twin_device).requires_grad_()
    before = dropout_apply.launches
    got = CounterDropout.apply(a, p, key, layer, site)
    got.backward(up)
    want = dropout_reference(b, p, key, layer, site)
    want.backward(up.to(twin_device))
    torch.cuda.synchronize()
    if dropout_apply.launches - before != 2:
        raise AssertionError("dropout: not 2 launches a site")
    if not (torch.equal(got.detach().to(twin_device), want.detach())
            and torch.equal(a.grad.to(twin_device), b.grad)):
        raise AssertionError(f"dropout kernel != twin: site {site} of "
                             f"{tuple(x.shape)}, {x.dtype}")


def phase_dropout_kernel(B=8, timed_B=64) -> dict:
    """The dropout kernel (``ops/dropout.py``) against its plain twin,
    forward and backward bit-equal, 2 launches a site: at the music step's
    four sites (block 256, 6 heads, 384 wide) at batch ``B`` against the
    twin on the CPU, bf16 and fp32; at batch ``timed_B`` (the shapes of
    phase 22's step and of the benchmark's music training, [64, 6, 256,
    256] and [64, 256, 384]) and at phase 30's TunesFormer sites (dropout
    0.1, each core under its own key, its last layer: the patch core's [8,
    128, 768] and [8, 12, 128, 128], the char core's [8 x 127, 32, 768]
    and [8 x 127, 12, 32, 32]) against the twin on the card, bf16. Then
    ms per call of the kernel and of the twin on the card at the attention
    probabilities of batch ``timed_B`` ([timed_B, 6, 256, 256], bf16, 2 x
    201 MB with its output, past the 50 MB L2), the kernel's output of the
    timed calls equal to the twin's: one call is one pass, forward or
    backward alike. No one PyTorch call computes the counter-hash mask, so
    there is no library time."""
    from ai_music_generation_tpu_torch.models import gpt
    from ai_music_generation_tpu_torch.models.tunesformer import (
        CHAR_CORE, PATCH_CORE, TunesFormerConfig, core_dropout_key,
    )
    from ai_music_generation_tpu_torch.ops.dropout import (
        dropout_apply, dropout_reference,
    )

    T, H, C, p = 256, 6, 384, 0.2
    key = gpt.dropout_key(1337, 100, 0)
    g = torch.Generator().manual_seed(0)

    def music_sites(batch):
        return ((gpt.SITE_EMBED, (batch, T, C)),
                (gpt.SITE_ATTN_PROBS, (batch, H, T, T)),
                (gpt.SITE_ATTN_OUT, (batch, T, C)),
                (gpt.SITE_MLP_OUT, (batch, T, C)))

    def draw(shape, dtype):
        return (torch.randn(shape, generator=g).to(dtype).cuda(),
                torch.randn(shape, generator=g).to(dtype).cuda())

    for dtype in (torch.bfloat16, torch.float32):
        for site, shape in music_sites(B):
            _dropout_vs_twin(*draw(shape, dtype), p, key, 5, site, "cpu")
    for site, shape in music_sites(timed_B):
        _dropout_vs_twin(*draw(shape, torch.bfloat16), p, key, 5, site,
                         "cuda")
    tc = TunesFormerConfig()
    TB, P, S, TH, TC = 8, tc.patch_length, tc.patch_size, tc.n_head, tc.n_embd
    rows = TB * (P - 1)  # every patch but the last conditions the next
    step_key = gpt.dropout_key(1337, 100)
    for core, layer, tokens, T_core in (
            (PATCH_CORE, tc.patch_layers - 1, TB, P),
            (CHAR_CORE, tc.char_layers - 1, rows, S)):
        for site, shape in ((gpt.SITE_EMBED, (tokens, T_core, TC)),
                            (gpt.SITE_ATTN_PROBS, (tokens, TH, T_core,
                                                   T_core)),
                            (gpt.SITE_ATTN_OUT, (tokens, T_core, TC)),
                            (gpt.SITE_MLP_OUT, (tokens, T_core, TC))):
            _dropout_vs_twin(*draw(shape, torch.bfloat16), tc.dropout,
                             core_dropout_key(step_key, core), layer, site,
                             "cuda")
    print(f"dropout kernel bit-equal to the twin, forward and backward: the "
          f"music step's four sites at batch {B} (CPU twin, bf16 and fp32) "
          f"and {timed_B} (twin on the card, bf16), TunesFormer's eight at "
          f"batch {TB} (twin on the card, bf16)")
    x = torch.randn((timed_B, H, T, T), device="cuda", dtype=torch.bfloat16)
    kernel, plain = [], []
    for order in (0, 1, 1, 0):  # plain, kernel, kernel, plain
        if order:
            kernel.append(_cuda_ms(lambda: dropout_apply(
                x, p, key, 5, gpt.SITE_ATTN_PROBS), 50))
        else:
            plain.append(_cuda_ms(lambda: dropout_reference(
                x, p, key, 5, gpt.SITE_ATTN_PROBS), 10))
    if not torch.equal(dropout_apply(x, p, key, 5, gpt.SITE_ATTN_PROBS),
                       dropout_reference(x, p, key, 5, gpt.SITE_ATTN_PROBS)):
        raise AssertionError("dropout kernel != twin at the timed shape")
    ms, plain_ms = min(kernel), min(plain)
    bound_ms, bound_by = bound(2 * x.nbytes, 0)
    print(f"dropout at [{timed_B}, {H}, {T}, {T}] bf16: kernel {kernel} "
          f"ms/call, twin {plain} ms/call (plain, kernel, kernel, plain); "
          f"best kernel {ms:.4f} ms, twin {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}: {2 * x.nbytes / 1e6:.1f} MB), "
          f"{bound_ms / ms:.3f} of it")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


class _Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _tee(fn, *args) -> str:
    import contextlib

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        fn(*args)
    return "".join(tee.parts)


def _iter_lines(log):
    """(iter, ms, mfu %, loss) of each ``iter N: ...`` line of a trainer
    log (a non-finite loss parsed as such)."""
    import re

    return [(int(a), float(c), float(d), float(b)) for a, b, c, d in
            re.findall(r"iter (\d+): loss (\S+), time ([\d.]+)ms, mfu "
                       r"(-?[\d.]+)%", log)]


def phase_train_cli(ws, device, iters=TRAIN_ITERS) -> dict:
    """``cli/train.py configs/irishman_char.py`` (batch 64, block 256,
    dropout 0.2, bf16) on phase 20's corpus for ``iters`` iterations with an
    eval every TRAIN_EVAL (TRAIN_EVAL_ITERS batches): the val loss falls
    below its first reading (the JAX gate, tests/test_trainer.py), ckpt.pt
    and last_iter_ckpt.pt exist; then ``--init_from=resume`` continues from
    the checkpoint's iteration with its model_args to iters + TRAIN_EVAL.
    ms/iter: the median over the iterations after the fifth whose window
    holds no eval; MFU: the trainer's EMA at the end. Returns the numbers
    and the out_dir."""
    import json
    import os
    import statistics

    from ai_music_generation_tpu_torch.cli import train as train_cli
    from ai_music_generation_tpu_torch.train import checkpoint as ckpt_lib

    data_root = ws[0]
    out = os.path.join(os.path.dirname(data_root), "train-music")
    base = [MUSIC_CONFIG, f"--data_root={data_root}", f"--out_dir={out}",
            f"--eval_interval={TRAIN_EVAL}",
            f"--eval_iters={TRAIN_EVAL_ITERS}", "--log_interval=1",
            f"--device={device}"]
    t0 = time.perf_counter()
    log = _tee(train_cli.main, base + [f"--max_iters={iters}"])
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "losses.jsonl")) as f:
        evals = [json.loads(line) for line in f]
    best = min(r["val/loss"] for r in evals[1:])
    if not best < evals[0]["val/loss"]:
        raise AssertionError(f"the music run's val loss did not fall: {evals}")
    for name in (ckpt_lib.BEST, ckpt_lib.LAST):
        if not ckpt_lib.checkpoint_exists(out, name):
            raise AssertionError(f"the music run wrote no {name}")
    lines = _iter_lines(log)
    steady = [ms for i, ms, _, _ in lines if i >= 5 and i % TRAIN_EVAL]
    ms = statistics.median(steady)
    mfu = lines[-1][2]
    last = ckpt_lib.load_checkpoint(out, ckpt_lib.LAST)
    resumed = _iter_lines(_tee(train_cli.main, base + [
        f"--max_iters={iters + TRAIN_EVAL}", "--init_from=resume"]))
    after = ckpt_lib.load_checkpoint(out, ckpt_lib.LAST)
    if (resumed[0][0] != last["iter_num"]
            or after["iter_num"] != iters + TRAIN_EVAL
            or after["model_args"] != last["model_args"]):
        raise AssertionError(
            f"resume: first iteration {resumed[0][0]}, checkpoint "
            f"{last['iter_num']} -> {after['iter_num']}")
    print(f"train CLI (music config, {device}): {iters} iterations in "
          f"{wall:.1f} s, val loss {evals[0]['val/loss']:.4f} -> {best:.4f} "
          f"({[round(r['val/loss'], 4) for r in evals]}); {ms:.2f} ms/iter "
          f"(median of {len(steady)}), MFU {mfu:.2f}%; resumed at iteration "
          f"{resumed[0][0]} to {after['iter_num']} with model_args "
          f"{after['model_args']}")
    return dict(out_dir=out, ms=ms, mfu=mfu, val=[r["val/loss"]
                                                  for r in evals])


def phase_sample_trained(ws, out_dir, device) -> float:
    """cli/sample.py from the music run's ckpt.pt: CLI_SPEC_SAMPLES tunes
    (4 conditioning measures, 200 new tokens, T 0.8, top_k 200), one file
    each with its X: header. Returns samples/s."""
    import shutil

    from ai_music_generation_tpu_torch.cli import sample as cli

    data_root, _, _, val_small = ws
    shutil.rmtree(f"{out_dir}/samples", ignore_errors=True)
    t0 = time.perf_counter()
    cli.main([f"--out_dir={out_dir}", f"--data_root={data_root}",
              "--dataset=irishman", "--tokens_format=char",
              f"--validation_path={val_small}", "--n_conditional_measures=4",
              "--max_new_tokens=200", "--temperature=0.8", "--top_k=200",
              f"--batch_size={CLI_SPEC_SAMPLES}", f"--device={device}"])
    wall = time.perf_counter() - t0
    files = _sample_files(out_dir)
    if sorted(files) != sorted(f"sample_{i}.abc"
                               for i in range(CLI_SPEC_SAMPLES)) or any(
            not text.startswith(f"X:{f[7:-4]}\n") for f, text in files.items()):
        raise AssertionError(f"samples of the trained model: {sorted(files)}")
    print(f"sample CLI from the trained ckpt.pt: {len(files)} tunes x 200 "
          f"new tokens in {wall:.2f} s; first: {files['sample_0.abc'][:80]!r}")
    return len(files) / wall


def phase_train_bench() -> dict:
    """cli/train_bench.py at GPT-2 124M (its defaults) on the card,
    BENCH_BURN_IN burn-in and BENCH_STEPS timed steps, without and with
    remat, then with ``--attn_impl=flash`` (the library counterpart of the
    einsum chain, ``scaled_dot_product_attention``): ms/iter, MFU against
    989 TFLOP/s, peak memory."""
    from ai_music_generation_tpu_torch.cli import train_bench

    res = {}
    for name, flag in (("plain", "--remat=False"), ("remat", "--remat=True"),
                       ("flash", "--attn_impl=flash")):
        res[name] = train_bench.main([
            f"--burn_in={BENCH_BURN_IN}", f"--num_steps={BENCH_STEPS}", flag,
            "--device=cuda"])
        torch.cuda.empty_cache()
    for name, r in res.items():
        if not (r["mfu"] > 0 and r["loss"] == r["loss"]):
            raise AssertionError(f"train_bench {name}: {r}")
    return res


# the music config's widths for --profile train (vocab 128: no corpus there)
MUSIC_PROFILED = dict(n_layer=6, n_head=6, n_embd=384, block_size=256,
                      batch_size=64, vocab_size=128, dropout=0.2)


def phase_profile_train(top=12) -> None:
    """One train step of cli/train_bench.py at GPT-2 124M, then at the
    music config's widths (MUSIC_PROFILED, dropout 0.2), under
    ``torch.profiler`` after 3 warm-up steps and one unprofiled step (host
    clock between synchronizes): device self time by kernel (entries whose
    device type is not the CPU), the busy share, and the device time under
    the optimizer step (``aten::_fused_adamw_``) and the dtype casts
    (``aten::_to_copy``: the fp32 weights cast to bf16 at each use and the
    upcasts to fp32, forward and backward); with dropout, the time of the
    forward's dropout alone (the kernel of ``ops/dropout.py`` at its four
    sites' shapes in every layer, CUDA events; the backward's is as much
    again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ai_music_generation_tpu_torch.cli import train_bench
    from ai_music_generation_tpu_torch.ops.dropout import dropout_apply

    for name, widths in (("GPT-2 124M", {}), ("music", MUSIC_PROFILED)):
        c = dict(train_bench.DEFAULTS, device="cuda", **widths)
        b = train_bench.setup(c)
        train_bench.timed_steps(b, 0, 3, c["seed"])
        wall, _ = train_bench.timed_steps(b, 3, 1, c["seed"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled, _ = train_bench.timed_steps(b, 4, 1, c["seed"])
        events = prof.key_averages()
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in events if e.device_type != DeviceType.CPU
                       and e.self_device_time_total > 0), reverse=True)
        busy_ms = sum(r[0] for r in rows)
        under = {op: sum(e.device_time_total for e in events
                         if e.key == op) / 1e3
                 for op in ("aten::_fused_adamw_", "aten::_to_copy")}
        B, T, C, H = (c["batch_size"], c["block_size"], c["n_embd"],
                      c["n_head"])
        shapes = [(B, T, C)] + [(B, H, T, T), (B, T, C), (B, T, C)] * c[
            "n_layer"]
        sites = [torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
                 for shape in shapes] if c["dropout"] else []
        dropout_ms = 0.0 if not sites else _cuda_ms(lambda: [
            dropout_apply(x, c["dropout"], 0, 0, 0) for x in sites], 3)
        print(f"profile train, {name}: batch {c['batch_size']} x "
              f"{c['block_size']}, dropout {c['dropout']}, bf16; unprofiled "
              f"step {wall * 1e3:.1f} ms, profiled {profiled * 1e3:.1f} ms; "
              f"device busy {busy_ms:.1f} ms = {busy_ms / 1e3 / profiled:.3f}"
              f" of the profiled wall, {busy_ms / 1e3 / wall:.3f} of the "
              f"unprofiled one; AdamW (aten::_fused_adamw_) "
              f"{under['aten::_fused_adamw_']:.2f} ms, dtype casts "
              f"(aten::_to_copy) {under['aten::_to_copy']:.2f} ms, dropout "
              f"kernel (forward) {dropout_ms:.2f} ms")
        for ms, count, key in rows[:top]:
            print(f"  {ms:10.2f} ms {count:7d} calls  {ms / count:.4f} "
                  f"ms/call  {key[:90]}")
        del b
        torch.cuda.empty_cache()


PROFILED = ("pallas", "bench", "spec", "serve", "train", "tunes",
            "tunes_serve", "tunes_train", "synth", "audiobox", "moe",
            "moe_serve", "gpt2")


@torch.inference_mode()
def phase_profile(path="pallas", B=BATCH, max_new=MAX_NEW, top=12) -> None:
    """One generate of ``path`` (pallas: phase 12's protocol, bench: phase
    5's, spec: phase 8's, moe: phase 38's bench config with 4 experts;
    serve: one hot pass of phase 19's load, moe_serve: of phase 39's; tunes:
    phase 26's generate at B=16; tunes_serve: one hot pass of phase 27's
    load; gpt2: phase 43's generate) under ``torch.profiler`` (CPU and
    CUDA activities) after a
    warm-up and an unprofiled run (timed with CUDA events; serve and the
    tunes paths: their wall after a synchronize): device self time by
    kernel, summed only over entries whose device type is not the CPU (a
    CPU op's entry repeats its kernels' device time), the device's busy
    share of the profiled wall, the device kernels of the run and, for the
    tunes paths, kernel launches a bar."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.decode.speculative import (
        SpecGenerator,
    )

    from ai_music_generation_tpu_torch.cli import serve_bench
    from ai_music_generation_tpu_torch.serve.engine import GenerationServer

    kw = dict(max_new_tokens=max_new, temperature=0.8, top_k=200)
    if path in ("tunes", "tunes_serve"):
        run, wall, what = _tunes_profiled(path)
    elif path == "gpt2":
        run, wall, what = _gpt2_profiled()
    elif path in ("serve", "moe_serve"):
        # one hot pass of phase 19's (39's) load on a warm server
        moe = path == "moe_serve"
        n = MOE_SERVE_REQUESTS if moe else SERVE_REQUESTS
        _, model = _bench_model("cuda", MOE_BENCH if moe else BENCH)
        srv = GenerationServer(model, n_slots=SERVE_SLOTS,
                               ticks_per_call=SERVE_TICKS,
                               admit_group=SERVE_GROUP, cache_len=SERVE_CACHE)
        serve_bench.run_pass(srv, n, SERVE_MAX_NEW, 1)
        _, wall = serve_bench.run_pass(srv, n, SERVE_MAX_NEW, 2)
        run = lambda: serve_bench.run_pass(  # noqa: E731
            srv, n, SERVE_MAX_NEW, 3)
        what = (f"{SERVE_SLOTS} slots, {n} requests (phase "
                f"{39 if moe else 19}'s hot pass)")
    else:
        _, model = _bench_model("cuda", {
            "pallas": PALLAS, "bench": BENCH, "spec": SPEC,
            "moe": MOE_BENCH}[path])
        gen = (SpecGenerator(model, n_draft=N_DRAFT, **kw) if path == "spec"
               else Generator(model, window=WINDOW, **kw)
               if path in ("bench", "moe") else Generator(model, **kw))
        prompts = torch.randint(0, model.config.vocab_size,
                                (B, PROMPT_LEN),
                                generator=torch.Generator().manual_seed(6),
                                dtype=torch.int32)
        gen.generate(prompts, seed=1)
        wall = _event_seconds(lambda: gen.generate(prompts, seed=2))
        run = lambda: gen.generate(prompts, seed=3)  # noqa: E731
        what = f"B={B}, {max_new} new tokens, window {gen.window}"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            _BarCounter() as bar_count:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    if bar_count.bars:
        bars = bar_count.bars
        what += (f"; {bars} bars, {launches} kernels = {launches / bars:.0f} "
                 f"a bar, {profiled / bars * 1e3:.2f} ms a bar profiled, "
                 f"{busy_ms / bars:.2f} ms of device time a bar")
    else:
        what += f"; {launches} kernels"
    print(f"profile {path}: {what}; unprofiled run {wall:.3f} s, profiled "
          f"{profiled:.3f} s; device busy {busy_ms:.1f} ms = "
          f"{busy_ms / 1e3 / profiled:.3f} of the profiled wall, "
          f"{busy_ms / 1e3 / wall:.3f} of the unprofiled one")
    for ms, count, key in rows[:top]:
        print(f"  {ms:10.1f} ms {count:7d} calls  {ms / count:.4f} ms/call  "
              f"{key[:90]}")


# -- the TunesFormer paths (phases 24-28) -------------------------------------

def _tunes_profiled(path):
    """(run, unprofiled wall s, description) of a tunes path to profile:
    ``tunes`` one generate of phase 26 (B=16, 32 patches), ``tunes_serve``
    one hot pass of phase 27's load, each after a warm run."""
    from ai_music_generation_tpu_torch.cli import serve_bench
    from ai_music_generation_tpu_torch.decode.tunes_generate import (
        TunesGenerator,
    )
    from ai_music_generation_tpu_torch.serve.tunes_engine import TunesServer

    _, model = _tunes_model("cuda")
    if path == "tunes_serve":
        srv = TunesServer(model, n_slots=TUNES_SLOTS)
        serve_bench.run_tunes_pass(srv, TUNES_SLOTS, TUNES_MAX_PATCH, 10_000)
        _, wall = serve_bench.run_tunes_pass(srv, TUNES_REQUESTS,
                                             TUNES_MAX_PATCH, 20_000)
        return (lambda: serve_bench.run_tunes_pass(
            srv, TUNES_REQUESTS, TUNES_MAX_PATCH),
            wall, f"{TUNES_SLOTS} slots, {TUNES_REQUESTS} requests (phase "
                  f"27's hot pass)")
    gen = TunesGenerator(model, top_p=0.8, top_k=8, temperature=1.2)

    def run(seed):
        gen.generate_tunes(TUNES_PROMPT, num_tunes=TUNES_GEN_B,
                           max_patch=TUNES_MAX_PATCH, seed=seed)
        torch.cuda.synchronize()

    run(1)
    t0 = time.perf_counter()
    run(2)
    return (lambda: run(3), time.perf_counter() - t0,
            f"B={TUNES_GEN_B}, {TUNES_MAX_PATCH} patches (phase 26)")


def _tunes_inputs(B, S, ring, pos, seed=0):
    """One K1 step at a TunesFormer shape (MHA, H = KH = 12, D = 64, bf16
    cache) as CPU tensors; in ring mode each row at a random length, row 0
    at 0 and row 1 at S - 1 (the extremes)."""
    args = _decode_inputs(False, False, pos, B, S, H=TUNES_H, KH=TUNES_H,
                          seed=seed)
    if ring:
        g = torch.Generator().manual_seed(seed + 1)
        lengths = torch.randint(0, S, (B,), generator=g)
        lengths[0] = 0
        if B > 1:
            lengths[1] = S - 1
        offset = (pos - torch.arange(S)) % S
        args[7] = (lengths[:, None] - offset[None, :]).to(torch.int32)
    return args


def _check_k1(dev, cpu, pos, device, what):
    """Launch K1 on ``dev`` and the twin on ``cpu`` (copies of the same
    inputs): caches bit-exact, out within one bf16 ulp of its range of the
    twin evaluated in fp32. Returns (the error, K1's output)."""
    from ai_music_generation_tpu_torch.ops.gqa_decode import (
        gqa_decode_reference, gqa_decode_update,
    )

    cpu32 = _upcast(cpu)
    pos_cpu = torch.tensor(pos, dtype=torch.int32)
    out = gqa_decode_update(*dev, pos_cpu.to(device))
    gqa_decode_update(*cpu, pos_cpu)
    ref32 = gqa_decode_reference(*cpu32, pos_cpu)
    _sync(device)
    for name, got, want in zip(("k", "v"), dev[1:3], cpu[1:3]):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name} differs: {what}")
    err = (out.float().cpu() - ref32).abs().max().item()
    if not err <= 2.0 ** -7 * ref32.abs().max().item():
        raise AssertionError(f"out differs from the fp32 twin by {err}: "
                             f"{what}")
    return err, out


# the batches at which the tunes main paths (phases 26-28) call K1: lockstep
# (the generator's patch and char steps, the server's char steps) and ring
# (the server's patch step); 3 rows beside them, a batch no path uses
TUNES_K1_LOCKSTEP_B = (TUNES_GEN_B, TUNES_GEN_BIG, TUNES_SLOTS,
                       TUNES_HTTP_SLOTS, TUNES_CLI_TUNES, 1, 3)
TUNES_K1_RING_B = (TUNES_SLOTS, TUNES_HTTP_SLOTS, 3)


def phase_tunes_kernel_vs_twin(device) -> tuple[float, set]:
    """K1 at the TunesFormer shapes (MHA H = KH = 12, D = 64, bf16 cache)
    and every batch the tunes main paths give it: the char core (S = 32,
    lockstep, pos 0, 1 and 31) and the patch core (S = 128, lockstep, pos
    0, 5, 127) at ``TUNES_K1_LOCKSTEP_B``, the server's ring patch core (S
    = 128, random lengths with 0 and 127, pos 0, 77, 127) at
    ``TUNES_K1_RING_B``: caches bit-exact, the output within one bf16 ulp
    of its range of the twin in fp32. Each lockstep case is also launched a
    second time at the same pos with the same K/V (the generator's rewound
    first bar rewrites its column so): the caches stay equal, the output
    repeats bit for bit. Returns (the largest error, the (B, S, ring)
    shapes checked)."""
    S_C, S_P = TUNES_SIZE, TUNES_LENGTH
    lockstep = ((S_C, (0, 1, S_C - 1)), (S_P, (0, 5, S_P - 1)))
    cases = [(b, s_len, False, pos) for b in set(TUNES_K1_LOCKSTEP_B)
             for s_len, ps in lockstep for pos in ps]
    cases += [(b, S_P, True, pos) for b in TUNES_K1_RING_B
              for pos in (0, 77, S_P - 1)]
    worst = 0.0
    for b, s_len, ring, pos in cases:
        what = f"B={b} S={s_len} ring={ring} pos={pos}"
        cpu = _tunes_inputs(b, s_len, ring, pos)
        dev = _to(cpu, device)
        err, out = _check_k1(dev, cpu, pos, device, what)
        worst = max(worst, err)
        if not ring:
            _, again = _check_k1(dev, cpu, pos, device, what + " (again)")
            if not torch.equal(again.cpu(), out.cpu()):
                raise AssertionError(f"a rewritten column changed the "
                                     f"output: {what}")
    print(f"K1 at the TunesFormer shapes (H=KH={TUNES_H}, D=64, bf16): "
          f"lockstep B {sorted(set(TUNES_K1_LOCKSTEP_B))} at S={S_C} (pos 0, "
          f"1, {S_C - 1}) and S={S_P} (pos 0, 5, {S_P - 1}); ring B "
          f"{sorted(TUNES_K1_RING_B)} at S={S_P} with lengths 0 and "
          f"{S_P - 1} among random ones; each lockstep column written twice:"
          f" caches bit-exact, out max abs err {worst} vs the fp32 twin")
    return worst, {(b, s_len, ring) for b, s_len, ring, _ in cases}


def _k1_tunes_bound(x, pos):
    """(bound ms, bound by) of one K1 call over the columns this call's
    data makes valid (lockstep: 0..pos; ring: mask_rel >= 0): reads q, the
    older valid columns of K and V, the slabs (and the mask); writes the
    fresh column and out; QK and PV two operations per (head, column,
    lane) each."""
    q, k, _, k_slab, _, _, _, mask_rel = x
    B, KHD, item = k.shape[0], k.shape[2], k.element_size()
    n_valid = (B * (pos + 1) if mask_rel is None
               else int((mask_rel >= 0).sum()))
    n = (2 * q.nbytes + 2 * (n_valid - B) * KHD * item + 2 * k_slab.nbytes
         + 2 * B * KHD * item)
    if mask_rel is not None:
        n += mask_rel.nbytes
    return bound(n, 4 * q.shape[1] * q.shape[2] * n_valid)


def phase_tunes_kernel_timing(B=TUNES_SLOTS) -> dict:
    """K1 and its twin timed on the card (plain, kernel, kernel, plain) at
    the char core's step (B rows, S = 32, lockstep, pos 31: every column
    valid), the generator's patch step (B rows, S = 128, lockstep, pos 127)
    and the server's patch step (B slots, S = 128, ring, random lengths),
    beside ``scaled_dot_product_attention`` over the valid
    columns (attention only: SDPA writes no column, so it does less than
    K1; printed as library_ms). Each timed input set is first held against
    the twin. Returns {name: the kernel's JSON numbers}."""
    import torch.nn.functional as F

    from ai_music_generation_tpu_torch.ops.gqa_decode import (
        gqa_decode_reference, gqa_decode_update,
    )

    res = {}
    for name, S, ring in (("tunes_char", TUNES_SIZE, False),
                          ("tunes_patch", TUNES_LENGTH, False),
                          ("tunes_ring", TUNES_LENGTH, True)):
        pos = S - 1
        cpu = _tunes_inputs(B, S, ring, pos, seed=3)
        err, _ = _check_k1(_to(cpu, "cuda"), [None if a is None else
                                               a.clone() for a in cpu],
                           pos, "cuda", f"timing {name}")
        x = _to(cpu, "cuda")
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        q, k, v = x[0], x[1], x[2]
        H, D = q.shape[1], q.shape[2]
        # SDPA's operands, laid out once outside the timed call: [B, H, 1,
        # D] queries over [B, H, S, D] keys and values, masked by validity
        qs = q[:, :, None, :].contiguous()
        ks = k.view(B, S, H, D).transpose(1, 2).contiguous()
        vs = v.view(B, S, H, D).transpose(1, 2).contiguous()
        mask = None if x[7] is None else (x[7] >= 0)[:, None, None, :]
        kernel, plain = _timed(lambda: gqa_decode_update(*x, p),
                               lambda: gqa_decode_reference(*x, p), 50, 10)
        library = [_cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask), 50) for _ in range(2)]
        ms, plain_ms = min(kernel), min(plain)
        bound_ms, bound_by = _k1_tunes_bound(x, pos)
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=min(library),
                         max_abs_err=err)
        print(f"K1 {name} (B={B}, S={S}, H=KH={H}, bf16, "
              f"{'ring' if ring else 'lockstep'}): kernel {kernel} ms, twin "
              f"{plain} ms (plain, kernel, kernel, plain); SDPA (attention "
              f"only, no column write) {library} ms; bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / ms:.3f} of it")
    return res


def _tunes_model(device, dtype=torch.bfloat16, config=None):
    """(CPU model, the same weights on ``device``): the reference
    TunesFormer (``TunesFormerConfig()``) at ``dtype``, init weights from
    seed 0, eval mode."""
    from ai_music_generation_tpu_torch.models.convert import (
        init_tunesformer_weights,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        TunesFormer, TunesFormerConfig,
    )

    cfg = config or TunesFormerConfig(dropout=0.0, dtype=dtype)
    cpu = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                   torch.Generator().manual_seed(0)).eval()
    if torch.device(device).type == "cpu":
        return cpu, cpu
    return cpu, copy.deepcopy(cpu).to(device).eval()


def _tunes_stack(L, S, B, extra=3, seed=5):
    """[B, L, S] patch stacks: the serve-bench prompt's patches, then
    ``extra`` random bars of printable chars, per row; returns (stack, n0 =
    the prompt's patches)."""
    from ai_music_generation_tpu_torch.decode.tunes_generate import (
        prepare_patch_state,
    )
    from ai_music_generation_tpu_torch.tokenizers.patchilizer import (
        Patchilizer,
    )

    p = Patchilizer()
    pp, _ = prepare_patch_state(p, TUNES_PROMPT, L, S)
    n0 = len(pp)
    g = torch.Generator().manual_seed(seed)
    stack = torch.zeros((B, L, S), dtype=torch.int32)
    stack[:, :n0] = torch.tensor(pp, dtype=torch.int32)
    for b in range(B):
        for i in range(extra):
            bar = "".join(chr(c) for c in torch.randint(
                32, 127, (int(torch.randint(4, S, (1,), generator=g)),),
                generator=g).tolist())
            stack[b, n0 + i] = torch.tensor(p.bar2patch(bar + "|", S))
    return stack, n0


@torch.inference_mode()
def phase_tunes_model(device, B=4):
    """The reference TunesFormer at full width on the card against the same
    init weights on the CPU, bf16 and fp32: ``encode_patches_cached`` of
    the serve-bench prompt (B rows, rewound to n0 - 1 as the generator
    does), 3 ``patch_step`` s, then a teacher-forced 32-position char scan
    from the last step's encoding: hidden states and logits within 2^-4 of
    their range (bf16), 1e-4 (fp32); exactly patch_layers K1 launches per
    patch step and char_layers per char step; and on the card the cached
    path against the full forwards (``encode_patches`` over the stack,
    ``char_logits``; ``bar_scan``'s conditioning) within the same
    yardstick."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update

    cuda = torch.device(device).type == "cuda"
    for dtype, frac in ((torch.bfloat16, 2.0 ** -4),
                        (torch.float32, FP32_MODEL_FRAC)):
        models = _tunes_model(device, dtype)
        cfg = models[0].config
        L, S = cfg.patch_length, cfg.patch_size
        stack, n0 = _tunes_stack(L, S, B)
        worst, launches = 0.0, []

        def close(got, want, what):
            want = want.float().cpu()
            got = got.float().cpu()
            if not torch.isfinite(got).all():
                raise AssertionError(f"non-finite {what} on the card")
            err = (got - want).abs().max().item() / want.abs().max().item()
            if not err <= frac:
                raise AssertionError(f"{what} differs by {err} of the range "
                                     f"({dtype})")
            return err

        hidden, logits = [], []
        for model in models:
            dev = model.device
            cache = KVCache.create(cfg.patch_core_config(), B, max_len=L,
                                   device=dev)
            model.encode_patches_cached(stack.to(dev), cache)
            cache.length.fill_(n0 - 1)
            hs = []
            for i in range(n0 - 1, n0 + 2):
                before = gqa_decode_update.launches
                h, _ = model.patch_step(stack[:, i].to(dev), cache)
                launches.append(gqa_decode_update.launches - before)
                hs.append(h)
            hidden.append(hs)
            ccache = KVCache.create(cfg.char_core_config(), B, max_len=S,
                                    device=dev)
            toks = stack[:, n0 + 2].to(dev)
            ls = []
            for j in range(S):
                before = gqa_decode_update.launches
                lg, _ = model.char_step(hs[-1], toks[:, j], ccache)
                launches.append(gqa_decode_update.launches - before)
                ls.append(lg)
            logits.append(torch.stack(ls, 1))
            if model is models[1]:  # the cached path vs the full forwards
                full = model.encode_patches(stack.to(dev))
                for k, h in enumerate(hs):
                    worst = max(worst, close(h, full[:, n0 - 1 + k],
                                             "cached vs full hidden"))
                worst = max(worst, close(
                    logits[-1], model.char_logits(full[:, n0 + 1], toks),
                    "cached vs full char logits"))
        for a, b in zip(hidden[1], hidden[0]):
            worst = max(worst, close(a, b, "patch_step hidden"))
        worst = max(worst, close(logits[1], logits[0], "char logits"))
        per_model = 3 + S
        want = ([cfg.patch_layers] * 3 + [cfg.char_layers] * S) if cuda \
            else [0] * per_model
        got = launches[per_model:] if cuda else launches[:per_model]
        if got != want:
            raise AssertionError(f"K1 launches per step {got}, want {want}")
        print(f"TunesFormer ({dtype}, {cfg.patch_layers}+{cfg.char_layers}"
              f" layers, {cfg.n_embd} wide) card vs CPU: "
              f"prefill + 3 patch steps + {S} char steps, B={B}: max err "
              f"{worst:.3e} of the range (within {frac}; the cached path vs "
              f"the full forwards on the card too); K1 {cfg.patch_layers} "
              f"per patch step, {cfg.char_layers} per char step")


def _k1_mode(S, ring):
    """The name of K1's TunesFormer mode at cache length S (its JSON
    entry's suffix)."""
    if ring:
        return "tunes_ring"
    return "tunes_char" if S == TUNES_SIZE else "tunes_patch"


class _K1Calls:
    """Inside a ``with`` block, the K1 calls of the models (a wrapper on
    ``models.gpt``'s ``gqa_decode_update``): the (B, S, KH*D, dtype, ring)
    of each (``keys``; ``shapes`` their (B, S, ring)), and their launches
    by TunesFormer mode (``_k1_mode``), each call's read from the kernel
    wrapper's own count."""

    @property
    def shapes(self) -> set:
        return {(B, S, ring) for B, S, _, _, ring in self.keys}

    def __enter__(self):
        from ai_music_generation_tpu_torch.models import gpt

        self.keys = set()
        self.launches = collections.Counter()
        self._gpt, orig = gpt, gpt.gqa_decode_update

        def recorded(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel,
                     pos):
            before = orig.launches
            out = orig(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel,
                       pos)
            B, S, ring = k.shape[0], k.shape[1], mask_rel is not None
            self.keys.add((B, S, k.shape[2], k.dtype, ring))
            self.launches[_k1_mode(S, ring)] += orig.launches - before
            return out

        gpt.gqa_decode_update = recorded
        self._orig = orig
        return self

    def __exit__(self, *exc):
        self._gpt.gqa_decode_update = self._orig


class _BarCounter:
    """Counts the bar steps of the generator and the server (a wrapper on
    ``TunesGenerator._bar_step`` and ``TunesServer._bar``) and the calls of
    K1's twin, inside a ``with`` block."""

    def __enter__(self):
        from ai_music_generation_tpu_torch.decode import tunes_generate
        from ai_music_generation_tpu_torch.ops import gqa_decode as ops
        from ai_music_generation_tpu_torch.serve import tunes_engine

        self.bars = self.twin_calls = 0
        self._saved = [(tunes_generate.TunesGenerator, "_bar_step"),
                       (tunes_engine.TunesServer, "_bar"),
                       (ops, "gqa_decode_reference")]
        self._orig = [getattr(o, n) for o, n in self._saved]

        def counted(fn, attr):
            def wrapper(*a, **kw):
                setattr(self, attr, getattr(self, attr) + 1)
                return fn(*a, **kw)
            return wrapper

        for (owner, name), fn in zip(self._saved, self._orig):
            setattr(owner, name, counted(
                fn, "twin_calls" if name == "gqa_decode_reference"
                else "bars"))
        return self

    def __exit__(self, *exc):
        for (owner, name), fn in zip(self._saved, self._orig):
            setattr(owner, name, fn)

    def check(self, launches, per_bar, device, what):
        want = self.bars * per_bar if torch.device(device).type == "cuda" \
            else 0
        if launches != want or self.bars == 0 or (
                want and self.twin_calls):
            raise AssertionError(
                f"{what}: {launches} K1 launches and {self.twin_calls} twin "
                f"calls for {self.bars} bars (want {want} launches)")


def _per_bar(cfg):
    """K1 launches a bar: a patch step (patch_layers) and patch_size char
    steps (char_layers each)."""
    return cfg.patch_layers + cfg.patch_size * cfg.char_layers


@torch.inference_mode()
def phase_tunes_generator(device, B=TUNES_GEN_B, big=TUNES_GEN_BIG,
                          max_patch=TUNES_MAX_PATCH):
    """``TunesGenerator`` (top_p 0.8, top_k 8, T 1.2) over the bf16
    reference TunesFormer at batch B, ``max_patch`` patches, the
    serve-bench prompt, twice at one seed: identical texts, every text
    starts with the prompt; exactly 105 K1 launches a bar (none of the
    twin's calls on the card). Then a batch of ``big``, printed. Returns
    (tunes/min at B, tunes/min at big, K1 launches, bars, peak GiB)."""
    from ai_music_generation_tpu_torch.decode.tunes_generate import (
        TunesGenerator,
    )
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update

    _, model = _tunes_model(device)
    gen = TunesGenerator(model, top_p=0.8, top_k=8, temperature=1.2)
    with _BarCounter() as count:
        before = gqa_decode_update.launches
        first = gen.generate_tunes(TUNES_PROMPT, num_tunes=B,
                                   max_patch=max_patch, seed=7)
        _sync(device)
        t0 = time.perf_counter()
        second = gen.generate_tunes(TUNES_PROMPT, num_tunes=B,
                                    max_patch=max_patch, seed=7)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = gqa_decode_update.launches - before
    count.check(launches, _per_bar(model.config), device,
                "TunesGenerator")
    if first != second:
        raise AssertionError("TunesGenerator: one seed, other texts")
    if len(first) != B or not all(t.startswith(TUNES_PROMPT)
                                  for t in first):
        raise AssertionError("TunesGenerator: a text lost its prompt")
    bars_each = count.bars // 2
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    big_out = gen.generate_tunes(TUNES_PROMPT, num_tunes=big,
                                 max_patch=max_patch, seed=8)
    _sync(device)
    big_wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if torch.device(device).type == "cuda" else 0.0)
    if len(big_out) != big:
        raise AssertionError("TunesGenerator: batch size")
    rate, big_rate = B / wall * 60, big / big_wall * 60
    chars = sum(len(t) - len(TUNES_PROMPT) for t in second)
    print(f"TunesGenerator at B={B}, max_patch {max_patch} (top_p 0.8, top_k"
          f" 8, T 1.2): {bars_each} bars in {wall:.3f} s = "
          f"{wall / bars_each * 1e3:.2f} ms a bar, {rate:.1f} tunes/min "
          f"({chars} chars); two runs at one seed identical; {launches} K1 "
          f"launches = {_per_bar(model.config)} x {count.bars} bars, no twin "
          f"call; B={big}: "
          f"{big_wall:.3f} s = {big_rate:.1f} tunes/min, peak {peak:.2f} GiB")
    return rate, big_rate, launches, count.bars, peak


@torch.inference_mode()
def phase_tunes_server(device, n_slots=TUNES_SLOTS, requests=TUNES_REQUESTS,
                       max_patch=TUNES_MAX_PATCH):
    """``TunesServer`` at ``n_slots`` slots under cli/serve_bench.py's tunes
    load (``requests`` requests of the serve-bench prompt at ``max_patch``
    patches, seeds 10,000 + i on the cold pass, i on the hot pass): every
    request finishes and starts with its prompt, K1 launches = 105 x bars
    (no twin call on the card); the hot pass's first request re-run alone
    in slot 0 and in slot 1 (admitted alone, behind a filler admitted a
    bar before) gives identical texts; the
    counter noise is bit-equal card vs CPU. Returns (tunes/min, latency,
    stats, K1 launches, peak GiB)."""
    from ai_music_generation_tpu_torch.cli import serve_bench
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update
    from ai_music_generation_tpu_torch.serve.tunes_engine import (
        TunesServer, tunes_noise_bits,
    )

    _, model = _tunes_model(device)
    srv = TunesServer(model, n_slots=n_slots)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with _BarCounter() as count:
        before = gqa_decode_update.launches
        _, cold = serve_bench.run_tunes_pass(srv, n_slots, max_patch, 10_000)
        srv.reset_stats()
        finished, wall = serve_bench.run_tunes_pass(srv, requests, max_patch)
        stats, latency = dict(srv.stats), srv.latency_stats()
        launches = gqa_decode_update.launches - before
        bars = count.bars
        first = min(finished, key=lambda r: r.id)
        kw = dict(max_patch=first.max_patch, top_p=first.top_p,
                  top_k=first.top_k, temperature=first.temperature,
                  seed=first.seed)
        reruns = []
        for filler in (False, True):  # alone in slot 0, then in slot 1
            if filler:  # admitted and run a bar first: rid's wave is rid
                srv.submit(TUNES_PROMPT, max_patch=max_patch, seed=99)
                srv.step()
            rid = srv.submit(first.prompt, **kw)
            reruns.append({r.id: r for r in srv.run_until_idle()}[rid].text)
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    count.check(gqa_decode_update.launches - before, _per_bar(model.config),
                device, "TunesServer")
    if len(finished) != requests or not all(
            r.done and r.text.startswith(TUNES_PROMPT) for r in finished):
        raise AssertionError("TunesServer: a request did not finish")
    if reruns[0] != reruns[1]:
        raise AssertionError("TunesServer: a request re-run alone gave "
                             "another text in another slot")
    g = torch.Generator().manual_seed(9)
    seed = torch.randint(0, 2**32, (4096,), generator=g, dtype=torch.int64)
    bar, idx = (torch.randint(0, 1 << 20, (4096,), generator=g,
                              dtype=torch.int32) for _ in range(2))
    if not torch.equal(tunes_noise_bits(seed.to(device), bar.to(device),
                                        idx.to(device), 128).cpu(),
                       tunes_noise_bits(seed, bar, idx, 128)):
        raise AssertionError("tunes counter noise differs between the card "
                             "and the CPU")
    rate = requests / wall * 60
    print(f"TunesServer: {n_slots} slots, admit_group {srv.admit_group}, "
          f"max_patch {max_patch}; cold pass {cold:.3f} s, hot pass "
          f"{requests} requests in {wall:.3f} s = {rate:.1f} tunes/min; "
          f"every request finished; {launches} K1 launches = "
          f"{_per_bar(model.config)} x {bars} bars (both passes), no twin "
          f"call; a request re-run alone in "
          f"slots 0 and 1 identical, equal to its hot-pass text: "
          f"{reruns[0] == first.text}; counter noise bit-equal card vs CPU; "
          f"peak {peak:.2f} GiB")
    print(f"TunesServer latency {latency}; phases {stats}")
    return rate, latency, stats, launches, peak


def _tunes_workspace(root, device, n_sheets=8):
    """A weights.pth of the reference TunesFormer's init weights (seed 0),
    written by the port's ``save_reference_checkpoint`` into ``root/tf``,
    loaded back by ``load_tunesformer`` with every parameter bit-equal; a
    prompt file (the serve-bench prompt) and a leadsheet JSON of
    ``n_sheets`` random ABC tunes with control codes. Returns (weights dir,
    prompt path, leadsheet path, the model's config)."""
    import os

    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        load_tunesformer,
    )
    from ai_music_generation_tpu_torch.models.tunesformer_export import (
        save_reference_checkpoint,
    )

    cpu, _ = _tunes_model("cpu")
    wdir = os.path.join(root, "tf")
    os.makedirs(wdir)
    save_reference_checkpoint(os.path.join(wdir, "weights.pth"), cpu)
    loaded, _ = load_tunesformer(wdir, device=device)
    ref = cpu.state_dict()
    for name, value in loaded.state_dict().items():
        if not torch.equal(value.cpu(), ref[name]):
            raise AssertionError(f"weights.pth round trip changed {name}")
    prompt = os.path.join(root, "prompt.txt")
    with open(prompt, "w") as f:
        f.write(TUNES_PROMPT)
    sheets = [{"id": 100 + i, "control code": "S:2\nB:9\nE:4\n",
               "abc notation": t}
              for i, t in enumerate(random_tunes(n_sheets, seed=3))]
    path = os.path.join(root, "leadsheets.json")
    with open(path, "w") as f:
        json.dump(sheets, f)
    print(f"weights.pth of the reference TunesFormer written by "
          f"save_reference_checkpoint, loaded back by load_tunesformer: "
          f"{len(ref)} tensors bit-equal")
    return wdir, prompt, path, cpu.config


def phase_tunes_http(ws, device, n_slots=TUNES_HTTP_SLOTS):
    """cli/serve_tunesformer.py's HTTP server over the workspace's
    weights.pth on 127.0.0.1 (a free port) in a thread: two identical
    seeded /generate requests give the same text, which starts with the
    prompt; /health reports the slots and the finished requests."""
    import threading
    import urllib.request

    from ai_music_generation_tpu_torch.cli import serve_tunesformer

    c = dict(serve_tunesformer.DEFAULTS, weights=ws[0], port=0,
             n_slots=n_slots, device=device)
    runner, httpd = serve_tunesformer.build_server(c)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        body = {"prompt": TUNES_PROMPT, "max_patch": TUNES_MAX_PATCH,
                "seed": 5}
        answers = []
        for _ in range(2):
            req = urllib.request.Request(
                f"{url}/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                answers.append(json.loads(r.read()))
        if answers[0]["text"] != answers[1]["text"] or not \
                answers[0]["text"].startswith(TUNES_PROMPT):
            raise AssertionError(f"/generate answers {answers}")
        with urllib.request.urlopen(f"{url}/health", timeout=60) as r:
            health = json.loads(r.read())
        if health["slots"] != n_slots or health["latency"]["count"] != 2 \
                or "engine_error" in health:
            raise AssertionError(f"/health {health}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.shutdown()
        thread.join(timeout=30)
    print(f"HTTP (cli/serve_tunesformer.py, {n_slots} slots): two seeded "
          f"/generate answers identical ({len(answers[0]['text'])} chars, "
          f"the prompt kept), /health latency {health['latency']}")


@torch.inference_mode()
def phase_tunes_cli(ws, device, num_tunes=TUNES_CLI_TUNES,
                    max_patch=TUNES_MAX_PATCH):
    """cli/tunesformer_generate.py (``-weights`` the workspace's directory,
    its weights.pth's architecture read from the shapes; ``num_tunes``
    tunes) and cli/sample_tunesformer.py (its leadsheets, ``--weights`` the
    same directory) on ``device``: the .abc file
    holds X:1..X:n, each tune with the prompt; one sample_<id>.abc with its
    X:<id> header per leadsheet; K1 launches = 105 x bars. Returns
    (K1 launches, bars)."""
    import argparse
    import contextlib
    import io
    import os

    from ai_music_generation_tpu_torch.cli import (
        sample_tunesformer, tunesformer_generate,
    )
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update

    wdir, prompt, sheets, cfg = ws
    root = os.path.dirname(wdir)
    args = argparse.Namespace(
        num_tunes=num_tunes, max_patch=max_patch, top_p=0.8, top_k=8,
        temperature=1.2, seed=3, show_control_code=True, weights=wdir,
        torch_weights="", prompt=prompt,
        output_dir=os.path.join(root, "output_tunes"), device=device)
    out_dir = os.path.join(root, "samples")
    with _BarCounter() as count:
        before = gqa_decode_update.launches
        with contextlib.redirect_stdout(io.StringIO()):
            path = tunesformer_generate.generate_abc(args)
            n = sample_tunesformer.main(
                [sheets, f"--weights={wdir}", f"--output_dir={out_dir}",
                 f"--max_patch={max_patch}", f"--device={device}"])
        launches = gqa_decode_update.launches - before
    count.check(launches, _per_bar(cfg), device, "the tunes CLIs")
    with open(path) as f:
        text = f.read()
    at = [text.find(f"X:{i + 1}\n{TUNES_PROMPT}") for i in range(num_tunes)]
    if at[0] != 0 or at != sorted(at) or f"X:{num_tunes + 1}\n" in text:
        raise AssertionError(f"tunesformer_generate wrote {path}: tunes at "
                             f"{at}")
    with open(sheets) as f:
        ids = [str(s["id"]) for s in json.load(f)]
    names = sorted(os.listdir(out_dir))
    if n != len(ids) or names != sorted(f"sample_{i}.abc" for i in ids):
        raise AssertionError(f"sample_tunesformer wrote {names}")
    for i in ids:
        with open(os.path.join(out_dir, f"sample_{i}.abc")) as f:
            if not f.read().startswith(f"X:{i}\n"):
                raise AssertionError(f"sample_{i}.abc lacks its header")
    print(f"tunesformer_generate: {num_tunes} tunes in {path}, X:1..X:"
          f"{num_tunes} with the prompt; sample_tunesformer: {n} files "
          f"sample_<id>.abc with X:<id>; {launches} K1 launches = "
          f"{_per_bar(cfg)} x {count.bars} bars, no twin call")
    return launches, count.bars


# -- TunesFormer training (phases 29-31) --------------------------------------

def _tunes_train_batch(B, cfg, seed=0):
    """[B, P, S] int32 on the CPU: tunes_mfu's bos/eos-framed ASCII patches,
    each row's patches past a random count (at least 4) zeroed (padding)."""
    from ai_music_generation_tpu_torch.experiments.tunes_mfu import (
        ascii_batch,
    )

    g = torch.Generator().manual_seed(seed)
    x = ascii_batch(g, B, cfg, "cpu")
    for b in range(B):
        x[b, int(torch.randint(4, cfg.patch_length, (1,), generator=g)):] = 0
    return x


def _bits(t):
    return t.detach().clone().view(torch.int32).cpu()


def phase_tunes_train_step(device, B=TUNES_TRAIN_B, steps=3) -> dict:
    """The TunesFormer train step (train/tunes_step.py: optax_adamw, the HF
    cosine schedule, the NaN guard) at the reference widths cut to
    TUNES_TRAIN_DEPTH on ``device`` against the CPU from the same init
    weights and batches: at fp32 and bf16 (dropout 0) ``steps`` steps, the
    loss of each within TRAIN_STEP_FRAC of its value, every parameter
    within it of the parameters' range and each Adam moment of its moments'
    range after the last; at dropout 0.1 two fp32 steps (the first at lr 0)
    within the fp32 yardstick, and the masks of each core's layer 0 at its
    four sites (each core under its own key) bit-equal card vs CPU;
    then the NaN guard on the card: a NaN parameter, a step, every
    parameter, moment and count bit for bit as before. Returns each error as
    a share of its yardstick's scale."""
    from ai_music_generation_tpu_torch.models import gpt
    from ai_music_generation_tpu_torch.models.convert import (
        init_tunesformer_weights,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        CHAR_CORE, PATCH_CORE, TunesFormer, TunesFormerConfig,
        core_dropout_key,
    )
    from ai_music_generation_tpu_torch.train.optimizer import (
        hf_cosine_schedule, optax_adamw,
    )
    from ai_music_generation_tpu_torch.train.tunes_step import (
        make_tunesformer_train_step,
    )

    errs, models = {}, None
    for name, dtype, p, n in (("fp32", torch.float32, 0.0, steps),
                              ("bf16", torch.bfloat16, 0.0, steps),
                              ("fp32 dropout", torch.float32, 0.1, 2)):
        cfg = TunesFormerConfig(**TUNES_TRAIN_DEPTH, dropout=p, dtype=dtype)
        cpu = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                       torch.Generator().manual_seed(0))
        models = (cpu, copy.deepcopy(cpu).to(device))
        opts, losses = [], []
        for m in models:
            opt = optax_adamw(m.parameters())
            step = make_tunesformer_train_step(
                m, opt, hf_cosine_schedule(TUNES_TRAIN_LR, 1.0, 10))
            losses.append([float(step(_tunes_train_batch(B, cfg, i).to(
                m.device), i, seed=7)) for i in range(n)])
            opts.append(opt)
        frac = TRAIN_STEP_FRAC[dtype]
        err = {"loss": max(abs(a - b) / abs(b)
                           for a, b in zip(losses[1], losses[0]))}
        ref = models[0].state_dict()
        span = max(float(v.abs().max()) for v in ref.values())
        err["params"] = max(float((v.cpu() - ref[k]).abs().max())
                            for k, v in models[1].state_dict().items()) / span
        for mo in ("exp_avg", "exp_avg_sq"):
            want = [st[mo] for st in opts[0].state.values()]
            span = max(float(v.abs().max()) for v in want)
            err[mo] = max(float((st[mo].cpu() - v).abs().max()) for v, st
                          in zip(want, opts[1].state.values())) / span
        print(f"tunes train step {name} ({device} vs cpu, {n} steps, batch "
              f"{B}, depth {TUNES_TRAIN_DEPTH}): losses {losses[1]} vs "
              f"{losses[0]}; errors "
              + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
              + f" (yardstick {frac:.3g})")
        if not all(v <= frac for v in err.values()):
            raise AssertionError(f"tunes train step {name}: {err} over "
                                 f"{frac}")
        errs[name] = max(err.values())
    cfg, model, opt = models[1].config, models[1], opts[1]
    C, H, P, S = cfg.n_embd, cfg.n_head, cfg.patch_length, cfg.patch_size
    N = B * (P - 1)
    key = gpt.dropout_key(7, 0)
    shapes = {PATCH_CORE: ((B, P, C), (B, H, P, P), (B, P, C), (B, P, C)),
              CHAR_CORE: ((N, S, C), (N, H, S, S), (N, S, C), (N, S, C))}
    kept = {}
    for core, sites in shapes.items():
        k = core_dropout_key(key, core)
        for site, shape in enumerate(sites):
            card = gpt.dropout_keep(shape, cfg.dropout, k, 0, site, device)
            if not torch.equal(card.cpu(), gpt.dropout_keep(
                    shape, cfg.dropout, k, 0, site)):
                raise AssertionError(f"dropout core {core} site {site}: "
                                     f"card != CPU")
            kept[(core, site)] = round(float(card.float().mean()), 4)
    # the NaN guard on the card
    step = make_tunesformer_train_step(
        model, opt, hf_cosine_schedule(TUNES_TRAIN_LR, 1.0, 10))
    with torch.no_grad():
        model.patch_embedding.bias[0] = float("nan")
    before = [_bits(p) for p in model.parameters()]
    state = [(_bits(s["exp_avg"]), _bits(s["exp_avg_sq"]), float(s["step"]))
             for s in opt.state.values()]
    loss = step(_tunes_train_batch(B, cfg, 9).to(device), 2, seed=7)
    if torch.isfinite(loss) or any(
            not torch.equal(_bits(p), b)
            for p, b in zip(model.parameters(), before)) or any(
            not torch.equal(_bits(s["exp_avg"]), m)
            or not torch.equal(_bits(s["exp_avg_sq"]), v)
            or float(s["step"]) != c
            for (m, v, c), s in zip(state, opt.state.values())):
        raise AssertionError("the NaN guard let a non-finite step through")
    print(f"tunes dropout masks (p {cfg.dropout}) bit-equal card vs CPU at "
          f"each core's layer-0 sites, kept shares {kept}; NaN guard on the "
          f"card: loss {float(loss)}, {len(before)} parameters, their "
          f"moments and the count ({state[0][2]:.0f}) bit for bit as before")
    return errs


def phase_tunes_train_cli(root, device, n_tunes=TUNES_CORPUS,
                          epochs=TUNES_EPOCHS) -> dict:
    """The real path: ``n_tunes`` random_tunes as .abc files,
    cli/add_control_codes.py -> data.json, cli/tunesformer_train.py at its
    defaults (the reference config: 9+3 layers, 768 wide, 128 x 32, batch
    8, bf16, dropout 0.1) for ``epochs`` epochs, then
    ``--load_from_checkpoint=True`` to ``epochs + 1``: the eval loss falls
    from epoch 1 to ``epochs``, weights.pth and logs.txt are written (an
    entry an epoch), the resume runs epoch ``epochs + 1`` alone from the
    checkpoint's weights and count. Returns the numbers, out_dir and the
    leadsheets of phase 30's sampling (TUNES_SHEETS curated tunes)."""
    import os
    import statistics

    from ai_music_generation_tpu_torch.cli import (
        add_control_codes, tunesformer_train,
    )
    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )
    from ai_music_generation_tpu_torch.models.tunesformer_import import (
        read_reference,
    )

    abc = os.path.join(root, "abc")
    os.makedirs(abc)
    for i, tune in enumerate(random_tunes(n_tunes, seed=11)):
        with open(os.path.join(abc, f"{i:05d}.abc"), "w") as f:
            f.write(tune)
    data = os.path.join(root, "data.json")
    t0 = time.perf_counter()
    curated = add_control_codes.main([abc, f"--output={data}"])
    curate_s = time.perf_counter() - t0
    out = os.path.join(root, "tf_train")
    base = [f"--data_path={data}", f"--out_dir={out}", f"--device={device}"]
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = tunesformer_train.main(base + [f"--num_epochs={epochs}"])
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if torch.device(device).type == "cuda" else 0.0)
    evals = [e["eval_loss"] for e in first["epochs"]]
    ckpt, _ = read_reference(os.path.join(out, "weights.pth"))
    if not evals[-1] < evals[0] or ckpt["epoch"] != first["best_epoch"]:
        raise AssertionError(f"the TunesFormer run's eval loss did not fall "
                             f"or its checkpoint is not the best epoch: "
                             f"{first}, checkpoint epoch {ckpt['epoch']}")
    resumed = tunesformer_train.main(base + [f"--num_epochs={epochs + 1}",
                                             "--load_from_checkpoint=True"])
    with open(os.path.join(out, "logs.txt")) as f:
        logged = [int(line.split()[1]) for line in f
                  if line.startswith("Epoch ")]
    steps = first["epochs"][0]["steps"]
    if ([e["epoch"] for e in resumed["epochs"]] != [epochs + 1]
            or logged != list(range(1, epochs + 2))
            or ckpt["update_count"] != ckpt["epoch"] * steps):
        raise AssertionError(f"resume: {resumed}, logs.txt epochs {logged}, "
                             f"checkpoint count {ckpt['update_count']}")
    epochs_run = first["epochs"] + resumed["epochs"]
    steady = [e["ms_per_iter"] for e in epochs_run[1:]]
    with open(data) as f:
        items = json.load(f)
    sheets = [dict(id=1000 + i, **item)
              for i, item in enumerate(items[:TUNES_SHEETS])]
    sheets_path = os.path.join(root, "leadsheets.json")
    with open(sheets_path, "w") as f:
        json.dump(sheets, f)
    print(f"tunes train CLI ({device}): {curated}/{n_tunes} tunes curated in "
          f"{curate_s:.2f} s; {epochs} epochs of {steps} steps in "
          f"{wall:.1f} s, eval loss {[round(v, 4) for v in evals]}, "
          f"resumed to epoch {epochs + 1} (eval "
          f"{resumed['epochs'][0]['eval_loss']:.4f}); ms/iter by epoch "
          f"{[round(e['ms_per_iter'], 3) for e in epochs_run]}, peak "
          f"{peak:.2f} GiB")
    return dict(out_dir=out, sheets=sheets_path, evals=evals, steps=steps,
                ms=statistics.median(steady), peak_gib=peak, wall=wall)


@torch.inference_mode()
def phase_tunes_sample_trained(trained, device, max_patch=TUNES_MAX_PATCH):
    """cli/sample_tunesformer.py over phase 30's weights.pth and
    TUNES_SHEETS of its curated tunes as leadsheets: one sample_<id>.abc
    with its X:<id> header each; 105 K1 launches a bar and no twin call
    on the card.
    Returns (K1 launches, bars)."""
    import contextlib
    import io
    import os

    from ai_music_generation_tpu_torch.cli import sample_tunesformer
    from ai_music_generation_tpu_torch.models.tunesformer import (
        load_tunesformer,
    )
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update

    out_dir = os.path.join(os.path.dirname(trained["out_dir"]), "samples")
    cfg = load_tunesformer(trained["out_dir"], device="cpu")[0].config
    with _BarCounter() as count:
        before = gqa_decode_update.launches
        with contextlib.redirect_stdout(io.StringIO()):
            n = sample_tunesformer.main(
                [trained["sheets"], f"--weights={trained['out_dir']}",
                 f"--output_dir={out_dir}", f"--max_patch={max_patch}",
                 f"--device={device}"])
        launches = gqa_decode_update.launches - before
    count.check(launches, _per_bar(cfg), device, "sampling the trained model")
    with open(trained["sheets"]) as f:
        ids = [str(s["id"]) for s in json.load(f)]
    for i in ids:
        with open(os.path.join(out_dir, f"sample_{i}.abc")) as f:
            if not f.read().startswith(f"X:{i}\n"):
                raise AssertionError(f"sample_{i}.abc lacks its header")
    if n != len(ids):
        raise AssertionError(f"sample_tunesformer wrote {n} samples")
    print(f"sample_tunesformer over the trained weights.pth: {n} samples, "
          f"{launches} K1 launches = {_per_bar(cfg)} x {count.bars} bars, "
          f"no twin call")
    return launches, count.bars


def phase_tunes_mfu() -> list:
    """experiments/tunes_mfu.py at B=8 and B=32 on the card: ms/iter,
    TFLOP/step (FlopCounterMode, equal to the analytic count), MFU against
    989 TFLOP/s, peak memory; a finite loss."""
    from ai_music_generation_tpu_torch.experiments import tunes_mfu

    res = tunes_mfu.main([f"--batches={','.join(map(str, TUNES_MFU_B))}",
                          "--device=cuda"])["tunes_mfu"]
    for r in res:
        if not (r["mfu"] > 0 and r["loss"] == r["loss"]
                and r["tflop_per_step"] == r["analytic_tflop"]):
            raise AssertionError(f"tunes_mfu: {r}")
    return res


def phase_profile_tunes_train(B=8, top=12) -> None:
    """One step of cli/tunesformer_train.py's configuration (the reference
    widths, batch 8, bf16, dropout 0.1) on tunes_mfu's batches under
    ``torch.profiler`` after 3 warm-up steps and one unprofiled step (host
    clock between synchronizes): device self time by kernel (entries whose
    device type is not the CPU), the busy share, the device time under the
    optimizer (``aten::_fused_adamw_``) and the dtype casts
    (``aten::_to_copy``), and the forward's dropout alone (the kernel of
    ``ops/dropout.py`` at every site's shape, CUDA events; the backward's
    is as much again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ai_music_generation_tpu_torch.experiments.tunes_mfu import (
        ascii_batch,
    )
    from ai_music_generation_tpu_torch.models.convert import (
        init_tunesformer_weights,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        TunesFormer, TunesFormerConfig,
    )
    from ai_music_generation_tpu_torch.ops.dropout import dropout_apply
    from ai_music_generation_tpu_torch.train.optimizer import (
        hf_cosine_schedule, optax_adamw,
    )
    from ai_music_generation_tpu_torch.train.tunes_step import (
        make_tunesformer_train_step,
    )

    cfg = TunesFormerConfig()
    model = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                     torch.Generator().manual_seed(0))
    model.to("cuda")
    opt = optax_adamw(model.parameters())
    step = make_tunesformer_train_step(model, opt,
                                       hf_cosine_schedule(5e-5, 10.0, 100))
    gen = torch.Generator("cuda").manual_seed(0)
    batches = [ascii_batch(gen, B, cfg, "cuda") for _ in range(5)]
    for i in range(3):
        step(batches[i], i, 49)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batches[3], 3, 49)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batches[4], 4, 49)
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in events if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    under = {op: sum(e.device_time_total for e in events
                     if e.key == op) / 1e3
             for op in ("aten::_fused_adamw_", "aten::_to_copy")}
    C, H, P, S = cfg.n_embd, cfg.n_head, cfg.patch_length, cfg.patch_size
    N = B * (P - 1)
    shapes = ([(B, P, C)] + [(B, H, P, P), (B, P, C), (B, P, C)]
              * cfg.patch_layers + [(N, S, C)]
              + [(N, H, S, S), (N, S, C), (N, S, C)] * cfg.char_layers)
    sites = [torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
             for shape in shapes]
    dropout_ms = _cuda_ms(lambda: [dropout_apply(x, cfg.dropout, 0, 0, 0)
                                   for x in sites], 3)
    print(f"profile tunes_train: batch {B} x {P} x {S}, the reference "
          f"widths, dropout {cfg.dropout}, bf16; unprofiled step "
          f"{wall * 1e3:.1f} ms, profiled {profiled * 1e3:.1f} ms; device "
          f"busy {busy_ms:.1f} ms = {busy_ms / 1e3 / profiled:.3f} of the "
          f"profiled wall, {busy_ms / 1e3 / wall:.3f} of the unprofiled one; "
          f"AdamW (aten::_fused_adamw_) {under['aten::_fused_adamw_']:.2f} "
          f"ms, dtype casts (aten::_to_copy) {under['aten::_to_copy']:.2f} "
          f"ms, dropout kernel (forward) {dropout_ms:.2f} ms")
    for ms, count, key in rows[:top]:
        print(f"  {ms:10.2f} ms {count:7d} calls  {ms / count:.4f} "
              f"ms/call  {key[:90]}")


# -- ABC -> WAV (phases 32-33) ------------------------------------------------

def _synth_corpus(n, seed=SYNTH_SEED):
    """``n`` tunes of the JAX package's protocol corpus: random ABC tunes
    (cli/random_baselines.py's recipe), compiled to MIDI by the port's
    compiler."""
    from ai_music_generation_tpu_torch.abcnotation.to_midi import abc_to_midi
    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )

    return [abc_to_midi(text) for text in random_tunes(n, seed)]


def _event_batch(midis, sample_rate=SYNTH_RATE):
    """The [tunes, events, 4] batch ``synthesize_midi_batch`` renders."""
    import numpy as np

    from ai_music_generation_tpu_torch.synth.render import midi_to_events

    events = [midi_to_events(m, sample_rate) for m in midis]
    batch = np.zeros((len(events), max(map(len, events)), 4), np.float32)
    for i, ev in enumerate(events):
        batch[i, :len(ev)] = ev
    return batch


def _crafted_synth(root, total):
    """The crafted batch of phase 32 and its sf2 voice: overlapping notes, a
    start past ``total``, one that runs past it, a pitch halfway between two
    bank roots (24: roots 21 and 27; argmin takes the first), both velocity
    layers of a font written by the port's ``write_sf2`` (two zones over one
    key range, split at velocity 64) and random notes, over 3 rows of 48,
    20 and 35 events."""
    import os

    import numpy as np

    from ai_music_generation_tpu_torch.synth.sf2 import write_sf2

    def sine(freq):
        t = np.arange(4800) / SYNTH_RATE
        return (0.8 * np.sin(2 * np.pi * freq * t)).astype(np.float32)

    font = os.path.join(root, "layers.sf2")
    write_sf2(font, [
        dict(wave=sine(220.0), root=57, key_range=(0, 63), vel_range=(0, 63),
             loop=(800, 4000), release_tc=-3600),
        dict(wave=sine(330.0), root=57, key_range=(0, 63),
             vel_range=(64, 127), release_tc=-2400),
        dict(wave=sine(880.0), root=81, key_range=(64, 127), attack_tc=-7200,
             sustain_cb=200, atten_cb=60),
    ])
    batch = np.zeros((3, 48, 4), np.float32)
    for row, n in enumerate((48, 20, 35)):
        rng = np.random.default_rng(row)
        ev = np.stack([rng.integers(28, 100, n).astype(np.float32),
                       rng.uniform(0, 0.8 * total, n).astype(np.float32),
                       rng.uniform(0.05, 1.5, n).astype(np.float32)
                       * SYNTH_RATE,
                       rng.uniform(0.1, 1.0, n).astype(np.float32)], 1)
        ev[:6] = [[24.0, 100.5, 8000.0, 0.7],
                  [60.0, total + 500.0, 4000.0, 0.5],
                  [62.0, 1000.0, 30000.0, 0.3], [66.0, 1200.7, 20000.0, 0.9],
                  [40.0, 1500.0, 12000.0, 0.45],
                  [40.0, total - 300.0, 9000.0, 0.55]]
        batch[row, :n] = ev
    return batch, f"sf2:{font}"


@torch.inference_mode()
def phase_synth_vs_twin(device="cuda", n_tunes=SYNTH_BATCH) -> dict:
    """``synth/render.py::render_events_batch`` at the pipeline's
    synth_batch and full ``total`` (120 s at 16 kHz) on ``device`` against
    the port on the CPU, for the three voices (sample_bank, additive, an sf2
    font with two velocity layers), on a batch of the protocol corpus and on
    the crafted batch: each wave within SYNTH_FRAC of its range, trim
    indices equal, two runs on ``device`` bit-equal; then
    ``synthesize_midi_batch``'s output lengths equal. Returns the largest
    error of each voice (share of the range)."""
    from ai_music_generation_tpu_torch.synth import render

    total = SYNTH_SECONDS * SYNTH_RATE
    midis = _synth_corpus(n_tunes)
    corpus = _event_batch(midis)
    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        crafted, font = _crafted_synth(tmp, total)
        for name, batch in (("corpus", corpus), ("crafted", crafted)):
            for voice in ("sample_bank", "additive", font):
                key = voice.split(":")[0]
                _reset_peak(device)
                t0 = time.perf_counter()
                first = render.render_events_batch(batch, total, voice=voice,
                                                   device=device)
                _sync(device)
                ms = (time.perf_counter() - t0) * 1e3
                peak = _peak_gib(device)
                second = render.render_events_batch(batch, total, voice=voice,
                                                    device=device)
                if not torch.equal(first, second):
                    raise AssertionError(f"two {key} renders of the {name} "
                                         f"batch on {device} differ")
                t0 = time.perf_counter()
                want = render.render_events_batch(batch, total, voice=voice,
                                                  device="cpu")
                cpu_ms = (time.perf_counter() - t0) * 1e3
                got = first.cpu()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{key} {name}: non-finite samples")
                span = want.amax(1) - want.amin(1)
                err = float(((got - want).abs().amax(1) / span).max())
                errs[key] = max(errs.get(key, 0.0), err)
                if err > SYNTH_FRAC:
                    raise AssertionError(f"{key} {name}: {err:.3e} of the "
                                         f"range off the CPU's render")
                trims = [(int(render.trim_trailing_silence(g)),
                          int(render.trim_trailing_silence(w)))
                         for g, w in zip(got, want)]
                if any(a != b for a, b in trims):
                    raise AssertionError(f"{key} {name}: trim indices "
                                         f"{trims} (card, CPU) differ")
                print(f"synth {name} {key}: {batch.shape[0]} x "
                      f"{batch.shape[1]} events x {total} samples, "
                      f"{err:.3e} of the range off the CPU, trims equal, "
                      f"card {ms:.1f} ms (first call), CPU {cpu_ms:.1f} ms, "
                      f"peak {peak:.2f} GiB")
        for voice in ("sample_bank", "additive"):
            lens = [[len(w) for w in render.synthesize_midi_batch(
                midis, voice=voice, device=d)] for d in (device, "cpu")]
            if lens[0] != lens[1]:
                raise AssertionError(f"synthesize_midi_batch lengths "
                                     f"{lens} (card, CPU) differ")
    print(f"phase 32: synth card vs CPU twin, max share of the range "
          f"{errs} (gate {SYNTH_FRAC}); output lengths equal")
    return errs


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(device) -> float:
    """Peak device memory since the last ``_reset_peak`` (0 on the CPU)."""
    if torch.device(device).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 2**30


def _timed_render(render, device):
    """Wrap ``render.render_events_batch`` so each call ends in a
    synchronize and adds its wall seconds to the returned list."""
    inner = render.render_events_batch
    seconds = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        return out

    return inner, timed, seconds


def phase_abc_to_wav(root, device="cuda", n_tunes=SYNTH_TUNES,
                     render_tunes=SYNTH_TUNES) -> dict:
    """cli/abc_to_midi_wav_and_aesthetics.py through ``main`` on ``device``
    with the proxy scorer, over ``n_tunes`` random ABC tunes (the JAX
    package's protocol, docs/PERF.md:11): n_failed 0, a MIDI and a WAV
    for every tune, an aesthetics row (finite proxy scores) and an inner
    similarity row for each; 8 of the WAVs against the CPU's render of their
    MIDIs (equal lengths, +-1 LSB). Prints tunes/min of the whole run and
    each stage's seconds, then the render's own tunes/min at synth_batch 8
    and 64 (over the first ``render_tunes``) with its peak memory."""
    import json
    import math
    import os

    import numpy as np

    from ai_music_generation_tpu_torch.cli import (
        abc_to_midi_wav_and_aesthetics as cli,
    )
    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )
    from ai_music_generation_tpu_torch.codec import midi_io
    from ai_music_generation_tpu_torch.synth import render
    from ai_music_generation_tpu_torch.synth.wav_io import read_wav, write_wav

    abc = os.path.join(root, "abc")
    os.makedirs(abc)
    for i, text in enumerate(random_tunes(n_tunes, SYNTH_SEED)):
        with open(os.path.join(abc, f"sample_{i}.abc"), "w") as f:
            f.write(text)
    out = os.path.join(root, "eval")
    inner, timed, render_s = _timed_render(render, device)
    render.render_events_batch = timed
    _reset_peak(device)
    try:
        t0 = time.perf_counter()
        result = cli.main([abc, out, f"--device={device}"])
        wall = time.perf_counter() - t0
    finally:
        render.render_events_batch = inner
    peak = _peak_gib(device)
    if result["n_failed"] != 0:
        raise AssertionError(f"the pipeline failed {result['n_failed']} "
                             f"tunes")
    midi_dir = os.path.join(out, "midi", "builtin")
    wav_dir = os.path.join(out, "wav", "builtin", "tpu_synth",
                           "builtin_sample_bank")
    aes_dir = os.path.join(out, "audiobox_aesthetics", "builtin",
                           "tpu_synth", "builtin_sample_bank")
    names = [f"file_{i}" for i in range(n_tunes)]
    for d, ext in ((midi_dir, ".mid"), (wav_dir, ".wav")):
        missing = [n for n in names
                   if not os.path.getsize(os.path.join(d, n + ext))]
        if sorted(os.listdir(d)) != sorted(n + ext for n in names) or missing:
            raise AssertionError(f"{d}: not one {ext} for each tune")
    rows = [json.loads(line) for line in
            open(os.path.join(aes_dir, "aesthetics.jsonl"))]
    inner_rows = open(os.path.join(out, "metrics", "builtin", "structure",
                                   "inner_similarity.jsonl")).readlines()
    if (len(rows) != n_tunes or len(inner_rows) != n_tunes
            or result["aesthetics_engine"] != "proxy"
            or not all(math.isfinite(r[a]) for r in rows
                       for a in ("CE", "CU", "PC", "PQ"))):
        raise AssertionError(f"{len(rows)} aesthetics rows, "
                             f"{len(inner_rows)} similarity rows, engine "
                             f"{result['aesthetics_engine']}")
    # the card's WAVs against the CPU's render of the same MIDIs
    midis = [midi_io.parse_midi_file(os.path.join(midi_dir, n + ".mid"))
             for n in names[:SYNTH_BATCH]]
    for name, want in zip(names, render.synthesize_midi_batch(midis,
                                                              device="cpu")):
        twin = os.path.join(root, "twin.wav")
        write_wav(twin, want)
        got, want = (read_wav(p)[0] for p in
                     (os.path.join(wav_dir, name + ".wav"), twin))
        lsb = np.abs(got - want).max() * 32767 if len(got) else 0.0
        if len(got) != len(want) or lsb > 1.0 + 1e-3:
            raise AssertionError(f"{name}.wav: {len(got)} samples vs the "
                                 f"CPU's {len(want)}, {lsb:.2f} LSB apart")
    stage = result["stage_seconds"]
    device_render = sum(render_s)
    print(f"phase 33: cli/abc_to_midi_wav_and_aesthetics.py on {device}, "
          f"{n_tunes} tunes, n_failed {result['n_failed']}: "
          f"{n_tunes / wall * 60:.1f} tunes/min ({wall:.1f} s); stages: "
          f"ABC->MIDI {stage['abc_to_midi']:.2f} s, render "
          f"{device_render:.2f} s ({len(render_s)} batches of "
          f"{SYNTH_BATCH}), trim and write "
          f"{stage['render'] - device_render + stage['write']:.2f} s, "
          f"metrics {stage['metrics']:.2f} s, scoring "
          f"{stage['scoring']:.2f} s; peak {peak:.2f} GiB; proxy means "
          f"{result['aesthetics']['mean']}; 8 WAVs within 1 LSB of the CPU")
    # the render alone at synth_batch 8 and 64 (after one warm batch; the
    # host clock around work that ends in a synchronize), over the first
    # render_tunes tunes
    midis = [midi_io.parse_midi_file(os.path.join(midi_dir, n + ".mid"))
             for n in names[:render_tunes]]
    total = SYNTH_SECONDS * SYNTH_RATE
    rates = {}
    for batch_size in (8, 64):
        batches = [_event_batch(midis[lo:lo + batch_size])
                   for lo in range(0, len(midis), batch_size)]
        render.render_events_batch(batches[0], total, device=device)
        _sync(device)
        _reset_peak(device)
        t0 = time.perf_counter()
        for b in batches:
            render.render_events_batch(b, total, device=device)
        _sync(device)
        secs = time.perf_counter() - t0
        rates[batch_size] = dict(
            tunes_per_min=len(midis) / secs * 60, peak_gib=_peak_gib(device),
            events=max(b.shape[1] for b in batches))
        print(f"render alone at synth_batch {batch_size}: "
              f"{rates[batch_size]['tunes_per_min']:.1f} tunes/min over "
              f"{len(midis)} tunes ({secs:.2f} s), peak "
              f"{rates[batch_size]['peak_gib']:.2f} GiB, up to "
              f"{rates[batch_size]['events']} events a batch")
    return dict(tunes_per_min=n_tunes / wall * 60, wall=wall, stage=stage,
                device_render=device_render, peak_gib=peak, render=rates)


@torch.inference_mode()
def phase_profile_synth(top=12) -> None:
    """One render batch (phase 32's corpus batch, sample_bank, synth_batch
    8, the full 120 s) under ``torch.profiler`` after a warm-up: the busy
    share of its wall, kernels a batch and the top device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ai_music_generation_tpu_torch.synth import render

    total = SYNTH_SECONDS * SYNTH_RATE
    batch = _event_batch(_synth_corpus(SYNTH_BATCH))
    render.render_events_batch(batch, total, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render.render_events_batch(batch, total, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render.render_events_batch(batch, total, device="cuda")
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile synth: one render batch, {batch.shape[0]} tunes x "
          f"{batch.shape[1]} events x {total} samples, sample_bank; "
          f"unprofiled {wall * 1e3:.1f} ms, profiled {profiled * 1e3:.1f} "
          f"ms; {sum(r[1] for r in rows)} kernels; device busy "
          f"{busy_ms:.2f} ms = {busy_ms / 1e3 / profiled:.3f} of the "
          f"profiled wall, {busy_ms / 1e3 / wall:.3f} of the unprofiled one")
    for ms, count, key in rows[:top]:
        print(f"  {ms:10.2f} ms {count:7d} calls  {ms / count:.4f} "
              f"ms/call  {key[:90]}")


# -- the Audiobox scorer (phases 34-35) --------------------------------------

def _audiobox_config():
    """``AudioboxConfig()`` (WavLM base: 7 convs of 512, 12 post-norm layers
    768 wide, 12 heads, FFN 3072, 320 buckets) with ``AUDIOBOX_WAVLM``'s
    overrides (none on the card)."""
    import dataclasses

    from ai_music_generation_tpu_torch.eval.audiobox import AudioboxConfig
    from ai_music_generation_tpu_torch.eval.wavlm import WavLMConfig

    return AudioboxConfig(wavlm=dataclasses.replace(WavLMConfig(),
                                                    **AUDIOBOX_WAVLM))


def _audiobox_checkpoint(path, cfg):
    """The seeded model saved as a torch checkpoint in the checkpoint layout,
    its positional conv split into weight norm's
    ``parametrizations.weight.original0/1`` (g = the kernel's norm over
    dims 0 and 1, v = the kernel), so that reading it composes the kernel.
    Returns the model's own state dict."""
    from ai_music_generation_tpu_torch.eval import audiobox

    model = audiobox.init_audiobox_weights(
        audiobox.AudioboxAesthetics(cfg),
        torch.Generator().manual_seed(AUDIOBOX_SEED))
    own = model.state_dict()
    sd = dict(own)
    base = "wavlm.encoder.pos_conv_embed.conv."
    v = sd.pop(base + "weight")
    sd[base + "parametrizations.weight.original0"] = \
        v.norm(dim=(0, 1), keepdim=True)
    sd[base + "parametrizations.weight.original1"] = v
    torch.save({"state_dict": sd}, path)
    return own


def _audiobox_chunks(device):
    """Four 10-s chunks at 16 kHz and their valid samples: noise, the first
    10 s of a protocol tune rendered by the synth, a chunk ragged at 3.7 s,
    a nearly silent one."""
    import numpy as np

    from ai_music_generation_tpu_torch.synth import render

    n = AUDIOBOX_CHUNK
    rng = np.random.default_rng(AUDIOBOX_SEED)
    tune = render.synthesize_midi_batch(_synth_corpus(1), device=device)[0]
    chunks = np.zeros((4, n), np.float32)
    chunks[0] = 0.1 * rng.normal(size=n)
    chunks[1, :min(n, len(tune))] = tune[:n]
    ragged = int(3.7 * SYNTH_RATE)
    chunks[2, :ragged] = 0.1 * rng.normal(size=ragged)
    chunks[3] = 1e-4 * rng.normal(size=n)
    return chunks, np.array([n, n, ragged, n], np.int32)


def _scored(pred, chunks, n_valid, pinned=True):
    """The predictor's scores of one block and its encoder's hidden states
    (on the host); ``pinned=False`` calls the model outside
    ``score_block``'s IEEE fp32 pin."""
    seen = []
    hook = pred.model.wavlm.register_forward_hook(
        lambda module, args, out: seen.append(out[1].cpu()))
    try:
        if pinned:
            scores = pred.score_block(chunks, n_valid)
        else:
            with torch.inference_mode():
                scores = pred.model(
                    torch.from_numpy(chunks).to(pred.device),
                    torch.from_numpy(n_valid).to(pred.device)).cpu().numpy()
    finally:
        hook.remove()
    return scores, seen[0]


def _share_of_range(got, want) -> float:
    return float((got - want).abs().max() / (want.max() - want.min()))


def _audiobox_errors(card, cpu_scores, cpu_hid, chunks, n_valid):
    """The card's hidden states and scores as shares of the range of the
    CPU's (the largest over the L+1 states), checked against
    AUDIOBOX_FRAC."""
    scores, hid = _scored(card, chunks, n_valid)
    scores = torch.from_numpy(scores)
    errs = dict(hidden=max(_share_of_range(h, w)
                           for h, w in zip(hid, cpu_hid)),
                scores=_share_of_range(scores, torch.from_numpy(cpu_scores)))
    if not (torch.isfinite(hid).all() and torch.isfinite(scores).all()):
        raise AssertionError("non-finite hidden states or scores")
    if max(errs.values()) > AUDIOBOX_FRAC:
        raise AssertionError(f"the Audiobox model on the card is {errs} of "
                             f"the range off the CPU's (gate "
                             f"{AUDIOBOX_FRAC})")
    return errs


@torch.inference_mode()
def _audiobox_timing(pred, batch, iters=AUDIOBOX_ITERS) -> dict:
    """The forward alone at ``batch`` 10-s chunks (CUDA events after a
    warm-up), ``score_waves`` from host to host over as many 10-s waves,
    the peak memory of a forward, and the FLOPs a chunk
    (``FlopCounterMode``) with their share of FP32_OPS_PER_S."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from ai_music_generation_tpu_torch.eval.audiobox import ieee_fp32

    rng = np.random.default_rng(batch)
    waves = (0.1 * rng.normal(size=(batch, AUDIOBOX_CHUNK))).astype(
        np.float32)
    x = torch.from_numpy(waves).cuda()
    n_valid = torch.full((batch,), AUDIOBOX_CHUNK, device="cuda")
    with ieee_fp32():
        with FlopCounterMode(display=False) as counter:
            pred.model(x, n_valid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = _cuda_ms(lambda: pred.model(x, n_valid), iters)
        peak = torch.cuda.max_memory_allocated() / 2**30
    pred.batch = batch
    pred.score_waves([(w, SYNTH_RATE) for w in waves])  # warm
    t0 = time.perf_counter()
    pred.score_waves([(w, SYNTH_RATE) for w in waves])
    host_ms = (time.perf_counter() - t0) * 1e3
    flops = counter.get_total_flops() / batch
    chunk_ms = ms / batch
    return dict(batch=batch, ms=ms, chunks_per_s=batch / ms * 1e3,
                score_waves_ms=host_ms,
                score_waves_chunks_per_s=batch / host_ms * 1e3,
                peak_gib=peak, gflop_per_chunk=flops / 1e9,
                bound_ms_per_chunk=flops / FP32_OPS_PER_S * 1e3,
                share=flops / FP32_OPS_PER_S * 1e3 / chunk_ms)


def phase_audiobox_model(root, device="cuda") -> dict:
    """The Audiobox predictor at ``AudioboxConfig()`` from a seeded init:
    its checkpoint (weight-norm positional conv) read back through
    ``load_torch_checkpoint``, ``config_from_state_dict`` and the loader
    (every key placed, nothing unmapped, the config equal); four 10-s
    chunks scored on ``device`` and on the CPU (every hidden state and the
    scores within AUDIOBOX_FRAC of their range), the card's bucket table at
    T=499 equal to the CPU's, a file alone scoring as in a crowd; then the
    same under PyTorch's default TF32 flags and float32 matmuls at "high"
    (the predictor pins IEEE fp32 itself); then the forward and
    ``score_waves`` timed at batch 8 and 10. Returns the numbers and the
    checkpoint's path."""
    import os

    import numpy as np

    from ai_music_generation_tpu_torch.eval import audiobox, wavlm

    cfg = _audiobox_config()
    ckpt = os.path.join(root, "audiobox.pth")
    own = _audiobox_checkpoint(ckpt, cfg)
    sd = audiobox.load_torch_checkpoint(ckpt)
    if audiobox.config_from_state_dict(sd) != cfg:
        raise AssertionError(f"config_from_state_dict read "
                             f"{audiobox.config_from_state_dict(sd)}")
    model = audiobox.AudioboxAesthetics(cfg)
    loaded, unmapped = audiobox.load_state_dict(model, sd)
    if unmapped or len(loaded) != len(own):
        raise AssertionError(f"{len(loaded)} keys placed of {len(own)}, "
                             f"unmapped {unmapped}")
    pos = "wavlm.encoder.pos_conv_embed.conv.weight"
    composed = _share_of_range(model.state_dict()[pos], own[pos])
    if composed > 1e-6:
        raise AssertionError(f"the composed positional conv is {composed} "
                             f"of its range off the saved kernel")

    card = audiobox.AesPredictor(weights=ckpt, batch=4, device=device)
    cpu = audiobox.AesPredictor(weights=ckpt, batch=4, device="cpu")
    chunks, n_valid = _audiobox_chunks(device)
    t0 = time.perf_counter()
    cpu_scores, cpu_hid = _scored(cpu, chunks, n_valid)
    cpu_s = time.perf_counter() - t0
    errs = _audiobox_errors(card, cpu_scores, cpu_hid, chunks, n_valid)
    frames = cfg.wavlm.frames_for_samples(AUDIOBOX_CHUNK)
    # the table the forward used (cached by the attention on its device)
    table = card.model.wavlm.encoder["layers"][0].attention.buckets(frames)
    if table.device.type != card.device.type or not torch.equal(
            table.cpu(), wavlm.relative_position_buckets(
                frames, frames, cfg.wavlm.num_buckets,
                cfg.wavlm.max_distance)):
        raise AssertionError(f"the bucket table at T={frames} on "
                             f"{table.device} is not the CPU's")
    rng = np.random.default_rng(AUDIOBOX_SEED + 1)
    wave = (0.05 * rng.normal(size=int(13.7 * SYNTH_RATE))).astype(
        np.float32)
    alone = card.score_wave(wave)
    crowd = card.score_waves([(chunks[1], SYNTH_RATE), (wave, SYNTH_RATE)])[1]
    drift = (max(abs(alone[a] - crowd[a]) for a in alone)
             / max(abs(v) for v in alone.values()))
    if drift > 1e-5:
        raise AssertionError(f"a file alone and in a crowd score {drift} "
                             f"of the largest score apart")

    # PyTorch's default TF32 flags (cuDNN on) and float32 matmuls at
    # "high": the predictor keeps its products in IEEE fp32 itself
    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        tf32_errs = _audiobox_errors(card, cpu_scores, cpu_hid, chunks,
                                     n_valid)
        # what a forward without the pin gives there (printed, not gated)
        _, hid = _scored(card, chunks, n_valid, pinned=False)
        unpinned = max(_share_of_range(h, w) for h, w in zip(hid, cpu_hid))
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    del cpu
    print(f"phase 34: the Audiobox model (WavLM {cfg.wavlm.num_layers} "
          f"layers x {cfg.wavlm.hidden_size}, {sum(v.numel() for v in own.values()) / 1e6:.1f}M "
          f"parameters) read back from its checkpoint ({len(loaded)} keys, "
          f"none unmapped, config equal); card vs CPU on 4 10-s chunks: "
          f"hidden states {errs['hidden']:.3e}, scores {errs['scores']:.3e} "
          f"of the range; under PyTorch's default TF32 flags "
          f"{tf32_errs['hidden']:.3e} / {tf32_errs['scores']:.3e} (an "
          f"unpinned forward there: {unpinned:.3e}); gate {AUDIOBOX_FRAC}; "
          f"buckets at T={frames} equal; alone vs crowd {drift:.2e}; CPU "
          f"forward {cpu_s:.1f} s")
    timing = {}
    if torch.device(device).type == "cuda":
        for batch in AUDIOBOX_BATCHES:
            timing[batch] = t = _audiobox_timing(card, batch)
            print(f"Audiobox forward at batch {batch}: {t['ms']:.2f} ms a "
                  f"batch, {t['chunks_per_s']:.1f} 10-s chunks/s; "
                  f"score_waves host to host {t['score_waves_ms']:.2f} ms "
                  f"({t['score_waves_chunks_per_s']:.1f} chunks/s); peak "
                  f"{t['peak_gib']:.2f} GiB; {t['gflop_per_chunk']:.2f} "
                  f"GFLOP a chunk (FlopCounterMode; reckoned ~148), bound "
                  f"{t['bound_ms_per_chunk']:.3f} ms a chunk at 67 TFLOP/s, "
                  f"share {t['share']:.3f}")
    return dict(ckpt=ckpt, errs=errs, tf32_errs=tf32_errs, unpinned=unpinned,
                drift=drift, timing=timing)


def phase_audio_aes_cli(root, ckpt, device="cuda",
                        n_pipeline=AUDIOBOX_PIPELINE_TUNES) -> dict:
    """cli/audio_aes.py (``--ckpt``, ``--batch-size 10``) on ``device`` over
    phase 33's ``wav_paths.jsonl`` under ``root`` with one missing path
    appended: a row each, the missing one all NaN, the others finite;
    files/min and chunks/s of the whole CLI, and the share of its wall in
    the predictor's blocks. Then ``EvalPipeline`` through
    cli/abc_to_midi_wav_and_aesthetics.py over the first ``n_pipeline``
    protocol tunes with ``$AUDIOBOX_WEIGHTS`` = ``ckpt``: the engine
    ``audio-aes`` and its rows within 1e-5 of the CLI's for the same
    tunes."""
    import json
    import math
    import os
    import wave

    from ai_music_generation_tpu_torch.cli import (
        abc_to_midi_wav_and_aesthetics as abc_cli,
    )
    from ai_music_generation_tpu_torch.cli import audio_aes
    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )
    from ai_music_generation_tpu_torch.eval import audiobox

    aes_dir = os.path.join(root, "eval", "audiobox_aesthetics", "builtin",
                           "tpu_synth", "builtin_sample_bank")
    paths = [json.loads(line)["path"] for line in
             open(os.path.join(aes_dir, "wav_paths.jsonl"))]
    chunks = 0
    for p in paths:
        with wave.open(p, "rb") as w:
            n = w.getnframes()
        chunks += sum(1 for s in range(0, max(n, 1), AUDIOBOX_CHUNK)
                      if s == 0 or n - s >= SYNTH_RATE // 10)
    inp = os.path.join(root, "audio_aes_in.jsonl")
    with open(inp, "w") as f:
        for p in paths + [os.path.join(root, "missing.wav")]:
            f.write(json.dumps({"path": p}) + "\n")
    out = os.path.join(root, "audio_aes_out.jsonl")
    block = audiobox.AesPredictor.score_block
    block_s = []

    def timed_block(self, *args):
        t0 = time.perf_counter()
        try:
            return block(self, *args)  # ends in a copy to the host
        finally:
            block_s.append(time.perf_counter() - t0)

    audiobox.AesPredictor.score_block = timed_block
    try:
        t0 = time.perf_counter()
        rc = audio_aes.main([inp, "--ckpt", ckpt, "--batch-size", "10",
                             "--output", out, f"--device={device}"])
        wall = time.perf_counter() - t0
    finally:
        audiobox.AesPredictor.score_block = block
    rows = [json.loads(line) for line in open(out)]
    if rc != 0 or len(rows) != len(paths) + 1 or not all(
            math.isnan(v) for v in rows[-1].values()) or not all(
            math.isfinite(v) for r in rows[:-1] for v in r.values()):
        raise AssertionError(f"audio_aes: rc {rc}, {len(rows)} rows for "
                             f"{len(paths) + 1} paths")
    by_name = {os.path.basename(p): r for p, r in zip(paths, rows)}
    print(f"phase 35: cli/audio_aes.py on {device} over {len(paths)} WAVs "
          f"+ 1 missing ({chunks} 10-s chunks): {len(rows)} rows, the "
          f"missing one NaN; {len(paths) / wall * 60:.1f} files/min, "
          f"{chunks / wall:.1f} chunks/s ({wall:.1f} s; predictor blocks "
          f"{sum(block_s):.1f} s in {len(block_s)} calls)")

    abc = os.path.join(root, "abc_aes")
    os.makedirs(abc)
    for i, text in enumerate(random_tunes(SYNTH_TUNES,
                                          SYNTH_SEED)[:n_pipeline]):
        with open(os.path.join(abc, f"sample_{i}.abc"), "w") as f:
            f.write(text)
    saved = os.environ.get("AUDIOBOX_WEIGHTS")
    os.environ["AUDIOBOX_WEIGHTS"] = ckpt
    try:
        t0 = time.perf_counter()
        result = abc_cli.main([abc, os.path.join(root, "eval_aes"),
                               f"--device={device}"])
        pipe_wall = time.perf_counter() - t0
    finally:
        if saved is None:
            del os.environ["AUDIOBOX_WEIGHTS"]
        else:
            os.environ["AUDIOBOX_WEIGHTS"] = saved
    pipe_dir = os.path.join(root, "eval_aes", "audiobox_aesthetics",
                            "builtin", "tpu_synth", "builtin_sample_bank")
    pipe_paths = [json.loads(line)["path"] for line in
                  open(os.path.join(pipe_dir, "wav_paths.jsonl"))]
    pipe_rows = [json.loads(line) for line in
                 open(os.path.join(pipe_dir, "aesthetics.jsonl"))]
    if result["aesthetics_engine"] != "audio-aes" or result["n_failed"] or \
            len(pipe_rows) != n_pipeline:
        raise AssertionError(f"the pipeline scored with "
                             f"{result['aesthetics_engine']}, "
                             f"{len(pipe_rows)} rows, n_failed "
                             f"{result['n_failed']}")
    diff = max(abs(r[a] - by_name[os.path.basename(p)][a])
               for p, r in zip(pipe_paths, pipe_rows) for a in r)
    if diff > 1e-5:
        raise AssertionError(f"the pipeline's rows are {diff} off the "
                             f"CLI's for the same tunes")
    print(f"phase 35: EvalPipeline with $AUDIOBOX_WEIGHTS over "
          f"{n_pipeline} tunes on {device}: engine audio-aes, rows within "
          f"{diff:.2e} of the CLI's; {pipe_wall:.1f} s (scoring "
          f"{result['stage_seconds']['scoring']:.1f} s)")
    return dict(files_per_min=len(paths) / wall * 60,
                chunks_per_s=chunks / wall, wall=wall, chunks=chunks,
                block_s=sum(block_s), pipeline_diff=diff,
                pipeline_wall=pipe_wall)


@torch.inference_mode()
def phase_profile_audiobox(batch=10, top=12) -> None:
    """One forward of the Audiobox predictor (phase 34's seeded WavLM base)
    at ``batch`` 10-s chunks under ``torch.profiler`` after a warm-up: the
    busy share of its wall, its kernels and the top device operations, and
    the device time of the convolutions, the GEMMs and the rest."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ai_music_generation_tpu_torch.eval import audiobox

    pred = audiobox.AesPredictor(
        _audiobox_config(), batch=batch, device="cuda",
        generator=torch.Generator().manual_seed(AUDIOBOX_SEED))
    waves = (0.1 * np.random.default_rng(batch).normal(
        size=(batch, AUDIOBOX_CHUNK))).astype(np.float32)
    n_valid = np.full(batch, AUDIOBOX_CHUNK, np.int32)
    pred.score_block(waves, n_valid)
    t0 = time.perf_counter()
    pred.score_block(waves, n_valid)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.score_block(waves, n_valid)
        profiled = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    kinds = collections.Counter()
    for ms, _, key in rows:
        name = key.lower()
        kinds["conv" if "conv" in name or "fprop" in name
              else "gemm" if "gemm" in name or "gemv" in name
              else "other"] += ms
    # the union of the kernels' intervals: the device's busy time even where
    # kernels overlap (their summed durations can exceed the wall)
    union_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in prof.events()
                         if e.device_type != DeviceType.CPU):
        union_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    print(f"profile audiobox: one forward, {batch} x 10-s chunks, WavLM "
          f"{pred.config.wavlm.num_layers} x {pred.config.wavlm.hidden_size}"
          f" fp32; unprofiled {wall * 1e3:.1f} ms, profiled "
          f"{profiled * 1e3:.1f} ms; {sum(r[1] for r in rows)} kernels, "
          f"{busy_ms:.2f} ms of kernel time; device busy (their intervals' "
          f"union) {union_us / 1e3:.2f} ms = "
          f"{union_us / 1e6 / profiled:.3f} of the profiled wall; by kind "
          f"(kernel names) "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.most_common()))
    for ms, count, key in rows[:top]:
        print(f"  {ms:10.2f} ms {count:7d} calls  {ms / count:.4f} "
              f"ms/call  {key[:90]}")


# MoE (phases 36-40): the repo's MoE protocol (docs/experiments/moe_tpu.py:
# 97-124, experiments/moe_probe.py): GPT 6 layers, 6 heads, 384 wide, block
# 256, vocab 128, bf16, 4 experts, top 2, capacity factor 1.25, aux weight
# 0.01; training at batch 64, lr 1e-3 (warmup 30, min 1e-4), dropout 0, on
# the probe's corpus; decode at B=256, 8-token prompts, 200 new tokens, T
# 0.8, top_k 200. Beside it the bench config with the same four experts
# (MOE_BENCH) at the bench protocol (B=4096, window 128, 500 new tokens)
# and served at docs/SERVING.md's headline (8192 slots, cache_len 128).
# Card vs CPU: routing equal but for tokens whose ranked probabilities lie
# within MOE_TIE of each other (counted); logits within 2^-4 of the range
# in bf16, FP32_MODEL_FRAC in fp32
MOE = dict(n_expert=4, expert_top_k=2, capacity_factor=1.25,
           moe_aux_coef=0.01)
MOE_GPT = dict(block_size=256, vocab_size=128, n_layer=6, n_head=6,
               n_embd=384, dropout=0.0, bias=False, dtype=torch.bfloat16,
               **MOE)
MOE_BENCH = dict(BENCH, **MOE)
MOE_TIE = 1e-6
# (the resume runs MOE_RESUME more iterations, a multiple of the eval
# interval, so that it ends on a checkpoint)
MOE_ITERS, MOE_EVAL, MOE_EVAL_ITERS, MOE_RESUME = 150, 50, 10, 50
MOE_DECODE_B, MOE_PROMPT, MOE_NEW, MOE_SAMPLES = 256, 8, 200, 64
MOE_SERVE_REQUESTS = 8192
# K1 at every shape the MoE paths give it, as (B, S, KH, int8, ring): the
# trained model's decode and sampling CLI (MHA, bf16 cache, block 256), the
# bench config's decode (KH=2, int8, window 128) and its serving tick
# (ring, 8192 slots)
MOE_K1_SHAPES = ((MOE_DECODE_B, 256, 6, False, False),
                 (MOE_SAMPLES, 256, 6, False, False),
                 (BATCH, WINDOW, 2, True, False),
                 (SERVE_SLOTS, SERVE_CACHE, 2, True, True))


def phase_moe_kernel_vs_twin(device) -> tuple[float, set]:
    """K1 at ``MOE_K1_SHAPES`` (pos 0, 7, 8, S-1; 0 and S-1 alone at B >=
    4096, whose twins take the host seconds a case; ring rows at random
    lengths): caches bit-exact, the output within one bf16 ulp of its
    range of the twin in fp32. Returns (the largest error, the shapes
    checked as (B, S, KH*D, cache dtype, ring))."""
    worst, checked = 0.0, set()
    for b, s_len, kh, quant, ring in MOE_K1_SHAPES:
        for pos in ((0, s_len - 1) if b >= BATCH else (0, 7, 8, s_len - 1)):
            cpu = _decode_inputs(quant, ring, pos, b, s_len, KH=kh)
            err, _ = _check_k1(_to(cpu, device), [
                None if a is None else a.clone() for a in cpu], pos, device,
                f"MoE shape B={b} S={s_len} KH={kh} int8={quant} "
                f"ring={ring} pos={pos}")
            worst = max(worst, err)
        checked.add((b, s_len, kh * 64, torch.int8 if quant
                     else torch.bfloat16, ring))
    print(f"K1 at the MoE paths' shapes (B, S, KH, int8, ring) "
          f"{list(MOE_K1_SHAPES)}, pos 0, 7, 8, S-1 (0, S-1 at B >= {BATCH})"
          f": caches bit-exact, out "
          f"max abs err {worst} vs the fp32 twin")
    return worst, checked


def phase_moe_kernel_timing(B=MOE_DECODE_B, S=MOE_GPT["block_size"]) -> dict:
    """K1 and its twin timed on the card (plain, kernel, kernel, plain) at
    the trained MoE model's decode step (B rows, MHA H = KH = 6, D = 64,
    bf16 cache, lockstep, pos S-1: every column valid), beside
    ``scaled_dot_product_attention`` over the same columns (attention only:
    it writes no column). The timed inputs are first held against the
    twin. Returns the JSON numbers."""
    import torch.nn.functional as F

    from ai_music_generation_tpu_torch.ops.gqa_decode import (
        gqa_decode_reference, gqa_decode_update,
    )

    pos, H, D = S - 1, MOE_GPT["n_head"], 64
    cpu = _decode_inputs(False, False, pos, B, S, H=H, KH=H, seed=3)
    err, _ = _check_k1(_to(cpu, "cuda"), [a if a is None else a.clone()
                                          for a in cpu], pos, "cuda",
                       "MoE timing")
    x = _to(cpu, "cuda")
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    qs = x[0][:, :, None, :].contiguous()
    ks, vs = (t.view(B, S, H, D).transpose(1, 2).contiguous()
              for t in x[1:3])
    kernel, plain = _timed(lambda: gqa_decode_update(*x, p),
                           lambda: gqa_decode_reference(*x, p), 50, 10)
    library = min(_cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs),
                           50) for _ in range(2))
    bound_ms, bound_by = _k1_tunes_bound(x, pos)
    ms = min(kernel)
    print(f"K1 at the MoE decode step (B={B}, S={S}, H=KH={H}, bf16, "
          f"lockstep): kernel {kernel} ms, twin {plain} ms (plain, kernel, "
          f"kernel, plain); SDPA (attention only) {library:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it")
    return dict(ms=ms, plain_ms=min(plain), bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library, max_abs_err=err)


def _moe_routes(model, out):
    """Forward hooks that append each MoE layer's (probabilities, expert
    indices, keep, slot, input) of each call to ``out``, on the CPU, as
    ``models.moe.route`` decides them."""
    from ai_music_generation_tpu_torch.models.moe import capacity_of, route

    def hook(moe, args, _):
        cfg = moe.config
        probs = moe.probs(args[0])
        K = min(cfg.expert_top_k, cfg.n_expert)
        _, idx, keep, slot = route(probs, K, capacity_of(
            probs.shape[0], cfg.n_expert, K, cfg.capacity_factor))
        out.append(tuple(t.cpu() for t in (probs, idx, keep, slot, args[0])))

    return [b.moe.register_forward_hook(hook) for b in model.transformer.h]


class _ForcedRouting:
    """Inside a ``with`` block, ``models.moe.route`` returns the given
    decisions (expert indices, keep, slot), one MoE layer after another,
    with gates renormalised from the caller's own probabilities: the CPU
    replays the card's routing, so that the two are compared on the same
    discrete choices."""

    def __init__(self, decisions):
        self.decisions = list(decisions)

    def __enter__(self):
        from ai_music_generation_tpu_torch.models import moe

        self._moe, self._orig = moe, moe.route
        queue = iter(self.decisions)

        def forced(probs, top_k, capacity):
            idx, keep, slot = (t.to(probs.device) for t in next(queue))
            gate = probs.gather(1, idx)
            return gate / gate.sum(-1, keepdim=True), idx, keep, slot

        moe.route = forced
        return self

    def __exit__(self, *exc):
        self._moe.route = self._orig


def _moe_compare(device, dtype, ids, frac, gate_routing):
    """One forward of the MoE_GPT model (all positions) on ``device``, and
    on the CPU from the same init weights replaying the card's routing
    (``_ForcedRouting``): the logits' error as a share of the range. The
    routing, in every dtype: the card's decisions (expert indices, keep,
    slot) must equal ``models.moe.route`` run on the CPU over the card's own
    probabilities; where the CPU's own choice on its input differs from the
    card's, the token is counted, and the CPU's ranked probabilities there
    must lie within 2 x the largest card-vs-CPU difference of that token's
    probabilities (the most by which rounding can reorder two experts: a
    routing fault is any flip it does not explain); with ``gate_routing``,
    every such token must also be a near-tie (ranked probabilities within
    MOE_TIE). Returns (share, near-tie tokens, tokens routed otherwise, the
    largest ranked-probability gap of those, the largest share of its bound
    that such a gap took, the CPU's layer-0 MoE input and probabilities, the
    card's model)."""
    from ai_music_generation_tpu_torch.models.moe import capacity_of, route

    cpu_model, model = _bench_model(device, dict(MOE_GPT, dtype=dtype))
    card, cpu = [], []
    hooks = _moe_routes(model, card)
    got, _ = model(ids.to(device), return_all_logits=True)
    hooks += _moe_routes(cpu_model, cpu)
    with _ForcedRouting([r[1:4] for r in card]):
        want, _ = cpu_model(ids, return_all_logits=True)
    for h in hooks:
        h.remove()
    got, want = got.float().cpu(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite MoE logits on the card")
    share = (got - want).abs().max().item() / want.abs().max().item()
    ties = flips = 0
    widest = explained = 0.0
    for (p_d, i_d, k_d, s_d, _), (p_c, i_c, k_c, _, _) in zip(card, cpu):
        N, E = p_c.shape
        K = i_c.shape[1]
        replay = route(p_d, K, capacity_of(N, E, K, MOE["capacity_factor"]))
        if not all(torch.equal(a, b) for a, b in zip(replay[1:],
                                                     (i_d, k_d, s_d))):
            raise AssertionError(f"MoE routing ({dtype}) on the card is not "
                                 f"route's on the card's own probabilities")
        # float64 differences of fp32 values are exact
        ranked = torch.sort(p_c.double(), -1, descending=True).values
        gaps = (ranked[:, :K] - ranked[:, 1:K + 1]).min(-1).values
        near = gaps < MOE_TIE
        moved = (i_d != i_c).any(-1)
        differ = moved | (k_d != k_c).any(-1)
        ties, flips = ties + int(near.sum()), flips + int(differ.sum())
        if moved.any():
            widest = max(widest, gaps[moved].max().item())
            bound = 2 * (p_d.double() - p_c.double()).abs().max(-1).values
            if (gaps[moved] > bound[moved]).any():
                raise AssertionError(
                    f"MoE routing ({dtype}) differs card vs CPU at "
                    f"{int((moved & (gaps > bound)).sum())} tokens whose "
                    f"ranked probabilities lie further apart than twice "
                    f"their card-vs-CPU difference")
            explained = max(explained, (gaps[moved] / bound[moved]).max()
                            .item())
        if gate_routing and (differ & ~near).any():
            raise AssertionError(
                f"MoE routing ({dtype}) differs card vs CPU at "
                f"{int((differ & ~near).sum())} tokens that are no near-tie")
    if not share <= frac:
        raise AssertionError(f"MoE logits ({dtype}) differ by {share} of the "
                             f"range > {frac}")
    return share, ties, flips, widest, explained, cpu[0][4], cpu[0][0], model


@torch.inference_mode()
def phase_moe_model(device, B=8) -> dict:
    """The MoE protocol's model (MOE_GPT, init weights from seed 0) on the
    card against the CPU, one forward of B x 256 tokens (all positions'
    logits; the CPU replays the card's routing, ``_moe_compare``, which
    in every dtype holds the card's routing to ``route`` on its own
    probabilities and each token routed otherwise to twice its
    probabilities' card-vs-CPU difference): fp32 (routing equal but for
    near-ties within MOE_TIE, which are counted; logits within
    FP32_MODEL_FRAC of the range), bf16 (logits within 2^-4; the tokens
    that bf16 rounding routes otherwise are counted with the widest gap
    among them: at init the router's probabilities lie close, and a token
    on another expert has other logits), fp32 again under PyTorch's
    default TF32 flags (cuDNN TF32 on, float32 matmuls at "highest"), and
    with float32 matmuls at "high" (TF32) the router on the CPU's layer-0
    input: pinned (``MoEMLP.probs``, IEEE fp32) within 1e-5 of the CPU's
    probabilities; an unpinned ``F.linear`` there is printed beside it."""
    import torch.nn.functional as F

    ids = torch.randint(0, MOE_GPT["vocab_size"], (B, MOE_GPT["block_size"]),
                        generator=torch.Generator().manual_seed(4),
                        dtype=torch.int32)
    res = {}
    fp32 = _moe_compare(device, torch.float32, ids, FP32_MODEL_FRAC, True)
    res["fp32"] = fp32[:5]
    res["bf16"] = _moe_compare(device, torch.bfloat16, ids, 2.0 ** -4,
                               False)[:5]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("highest")
        res["fp32 default flags"] = _moe_compare(
            device, torch.float32, ids, FP32_MODEL_FRAC, True)[:5]
        torch.set_float32_matmul_precision("high")
        x, probs, model = fp32[5:]
        moe = model.transformer.h[0].moe
        xd = x.to(device).float().reshape(-1, x.shape[-1])
        pinned = (moe.probs(xd).cpu() - probs).abs().max().item()
        plain = (torch.softmax(F.linear(xd, moe.router.weight), -1).cpu()
                 - probs).abs().max().item()
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    if not pinned <= 1e-5:
        raise AssertionError(f"the pinned router under TF32 differs from "
                             f"the CPU's by {pinned}")
    res["router at high"] = (pinned, plain)
    for name, (share, ties, flips, widest, explained) in list(
            res.items())[:3]:
        print(f"MoE model {name} (4 experts, top 2, {B} x "
              f"{MOE_GPT['block_size']} tokens, {MOE_GPT['n_layer']} layers) "
              f"card vs CPU: logits {share:.3e} of the range (the CPU "
              f"replaying the card's routing); the card's routing is route's "
              f"on its probabilities; {ties} near-tie token decisions "
              f"(ranked probabilities within {MOE_TIE}); {flips} tokens the "
              f"CPU would route otherwise on the same input, ranked "
              f"probabilities at most {widest:.3e} apart, at most "
              f"{explained:.3f} of twice their card-vs-CPU difference")
    print(f"MoE router with float32 matmuls at 'high' (TF32): pinned "
          f"(MoEMLP.probs) {pinned:.3e} from the CPU's probabilities, "
          f"unpinned F.linear {plain:.3e}")
    return res


def _moe_flags(config: dict) -> list:
    return [f"--{k}={v}" for k, v in config.items()]


def phase_moe_train(root, device) -> dict:
    """``cli/train.py`` at the MoE protocol (experiments/moe_probe.py's
    corpus, PROTOCOL and MOE flags) for MOE_ITERS iterations with an eval
    every MOE_EVAL: the val loss falls, ckpt.pt and last_iter_ckpt.pt
    exist, ``model_args`` carries the MoE keys; ``--init_from=resume`` with
    the dense flags continues from the checkpoint's iteration with its MoE
    model_args to MOE_ITERS + MOE_RESUME. ms/iter: the median over the
    iterations after the fifth whose window holds no eval; MFU: the
    trainer's EMA (every expert counted, so inflated). Then the train step
    of a dense and an MoE trainer at the protocol (``moe_probe.
    time_steps``: 20 steps, CUDA events): ms, their ratio beside the FLOP
    ratio (``moe_probe.step_flops``), peak memory. Returns the numbers, the
    out_dir and the corpus."""
    import os
    import statistics

    from ai_music_generation_tpu_torch.cli import train as train_cli
    from ai_music_generation_tpu_torch.experiments import moe_probe
    from ai_music_generation_tpu_torch.models.nanogpt_ckpt import MOE_KEYS
    from ai_music_generation_tpu_torch.train import checkpoint as ckpt_lib
    from ai_music_generation_tpu_torch.train.trainer import Trainer

    data_root = os.path.join(root, "data")
    moe_probe.write_corpus(data_root)
    out = os.path.join(root, "moe")
    base = [f"--dataset={moe_probe.CORPUS}", f"--data_root={data_root}",
            f"--out_dir={out}", f"--eval_interval={MOE_EVAL}",
            f"--eval_iters={MOE_EVAL_ITERS}", "--log_interval=1",
            f"--lr_decay_iters={MOE_ITERS}", f"--device={device}"]
    base += _moe_flags(moe_probe.PROTOCOL)
    t0 = time.perf_counter()
    log = _tee(train_cli.main, base + _moe_flags(moe_probe.MOE)
               + [f"--max_iters={MOE_ITERS}"])
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "losses.jsonl")) as f:
        evals = [json.loads(line)["val/loss"] for line in f]
    if not min(evals[1:]) < evals[0]:
        raise AssertionError(f"the MoE run's val loss did not fall: {evals}")
    last = ckpt_lib.load_checkpoint(out, ckpt_lib.LAST)
    if not ckpt_lib.checkpoint_exists(out, ckpt_lib.BEST) or {
            k: last["model_args"].get(k) for k in MOE_KEYS} != moe_probe.MOE:
        raise AssertionError(f"the MoE run's checkpoints: model_args "
                             f"{last['model_args']}")
    lines = _iter_lines(log)
    ms = statistics.median(m for i, m, _, _ in lines
                           if i >= 5 and i % MOE_EVAL)
    resumed = _iter_lines(_tee(train_cli.main, base + [
        f"--max_iters={MOE_ITERS + MOE_RESUME}", "--init_from=resume"]))
    after = ckpt_lib.load_checkpoint(out, ckpt_lib.LAST)
    if (resumed[0][0] != last["iter_num"]
            or after["iter_num"] != MOE_ITERS + MOE_RESUME
            or after["model_args"] != last["model_args"]):
        raise AssertionError(f"MoE resume: first iteration {resumed[0][0]}, "
                             f"checkpoint {last['iter_num']} -> "
                             f"{after['iter_num']}, model_args "
                             f"{after['model_args']}")
    steps = {}
    for name, moe in (("dense", False), ("moe", True)):
        t = Trainer(moe_probe.trainer_config(
            data_root, os.path.join(root, f"steps_{name}"), MOE_ITERS, moe,
            device))
        steps[name] = dict(moe_probe.time_steps(t), tflop=moe_probe.step_flops(
            t.gpt_config, t.micro_batch) / 1e12)
        del t
        torch.cuda.empty_cache()
    ratio = steps["moe"]["ms"] / steps["dense"]["ms"]
    flop_ratio = steps["moe"]["tflop"] / steps["dense"]["tflop"]
    print(f"MoE train CLI ({device}): {MOE_ITERS} iterations in {wall:.1f} s,"
          f" val loss {[round(v, 4) for v in evals]}; {ms:.2f} ms/iter "
          f"(median), MFU {lines[-1][2]:.2f}% (every expert counted: "
          f"inflated); resumed at {resumed[0][0]} to {after['iter_num']} with"
          f" model_args {after['model_args']}")
    print(f"MoE vs dense train step (20 steps, CUDA events): dense "
          f"{steps['dense']['ms']:.2f} ms, MoE {steps['moe']['ms']:.2f} ms, "
          f"ratio {ratio:.3f} beside the FLOP ratio {flop_ratio:.3f} "
          f"({steps['moe']['tflop']:.3f} / {steps['dense']['tflop']:.3f} "
          f"TFLOP a step); peak {steps['dense']['peak_gib']} / "
          f"{steps['moe']['peak_gib']} GiB")
    return dict(out_dir=out, data_root=data_root, ms=ms, mfu=lines[-1][2],
                val=evals, steps=steps, ratio=ratio, flop_ratio=flop_ratio)


def _k1_launches():
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update

    return gqa_decode_update.launches


@torch.inference_mode()
def phase_moe_decode(train, device) -> dict:
    """The trained MoE model (its ckpt.pt, bf16) through ``moe_probe.
    decode`` at B=256, 8-token val.bin prompts, 200 new tokens, T 0.8,
    top_k 200: two same-seed generates bit-equal, then two timed (CUDA
    events); exactly n_layer x 200 K1 launches a generate (4 generates).
    Returns tok/s, peak memory and launches."""
    import os

    from ai_music_generation_tpu_torch.experiments import moe_probe
    from ai_music_generation_tpu_torch.models.nanogpt_ckpt import load_ckpt

    model, _ = load_ckpt(os.path.join(train["out_dir"], "ckpt.pt"),
                         device=device)
    if model.config.n_expert != MOE["n_expert"]:
        raise AssertionError(f"the trained model: {model.config}")
    prompts = moe_probe.val_prompts(train["data_root"], MOE_DECODE_B,
                                    MOE_PROMPT)
    _reset_peak(device)
    before = _k1_launches()
    res = moe_probe.decode(model, prompts, MOE_NEW, runs=2)
    launches = _k1_launches() - before
    want = (4 * model.config.n_layer * MOE_NEW
            if torch.device(device).type == "cuda" else 0)
    if launches != want:
        raise AssertionError(f"MoE decode: {launches} K1 launches for 4 "
                             f"generates (want {want})")
    res.update(peak_gib=_peak_gib(device), launches=launches)
    print(f"MoE decode (trained, B={MOE_DECODE_B}, {MOE_NEW} new tokens): "
          f"same seed bit-equal, {res['tok_s']:.1f} tok/s {res['seconds']} s,"
          f" peak {res['peak_gib']:.2f} GiB; {launches} K1 launches = 4 x "
          f"n_layer x {MOE_NEW}")
    return res


@torch.inference_mode()
def phase_moe_bench_decode(device) -> dict:
    """The bench config with 4 experts (MOE_BENCH, init weights) at the
    bench protocol (B=4096, 8-token prompts, window 128, 500 new tokens, T
    0.8, top_k 200): two same-seed generates bit-equal, each exactly
    n_layer x 500 = 3000 K1 launches, the second timed (CUDA events on the
    card): tok/s, peak memory (the windowed refresh routes 4096 x 64
    tokens a layer through the index dispatch)."""
    from ai_music_generation_tpu_torch.decode.generate import Generator

    _, model = _bench_model(device, MOE_BENCH)
    gen = Generator(model, max_new_tokens=MAX_NEW, temperature=0.8,
                    top_k=200, window=WINDOW)
    prompts = torch.randint(0, model.config.vocab_size, (BATCH, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(2),
                            dtype=torch.int32)
    _reset_peak(device)
    runs, outs = [], []
    for _ in range(2):  # the second run's time is kept: the first is warm-up
        before = _k1_launches()
        seconds = _event_seconds(
            lambda: outs.append(gen.generate(prompts, seed=1234)))
        runs.append((outs[-1].cpu(), _k1_launches() - before))
    want = (model.config.n_layer * MAX_NEW
            if torch.device(device).type == "cuda" else 0)
    if not (torch.equal(runs[0][0], runs[1][0])
            and runs[0][1] == runs[1][1] == want):
        raise AssertionError(f"MoE bench decode: same seed equal "
                             f"{torch.equal(runs[0][0], runs[1][0])}, K1 "
                             f"launches {runs[0][1]}, {runs[1][1]} (want "
                             f"{want})")
    out = runs[0][0]
    if not (torch.equal(out[:, :PROMPT_LEN], prompts)
            and ((out >= 0) & (out < model.config.vocab_size)).all()):
        raise AssertionError("MoE bench decode: prompts or token range")
    tok_s = BATCH * MAX_NEW / seconds
    peak = _peak_gib(device)
    print(f"MoE bench decode (bench config + 4 experts, B={BATCH}, window "
          f"{WINDOW}, {MAX_NEW} new tokens): same seed bit-equal, "
          f"{runs[0][1]} K1 launches a generate; {tok_s:.1f} tok/s "
          f"({seconds:.3f} s), peak {peak:.2f} GiB")
    return dict(tok_s=tok_s, peak_gib=peak)


@torch.inference_mode()
def phase_moe_serve(device, requests=MOE_SERVE_REQUESTS) -> dict:
    """``GenerationServer`` over MOE_BENCH at the serving headline (8192
    slots, cache_len 128, waves of 512, 64 ticks a call) under
    cli/serve_bench.py's load: a cold pass of requests / 4, then a hot
    pass of ``requests`` (128-256 new tokens): every request finishes with
    its budget, tokens in range, K1 (ring) launches = n_layer x ticks.
    tok/s and latency of the hot pass, peak memory."""
    from ai_music_generation_tpu_torch.cli import serve_bench
    from ai_music_generation_tpu_torch.serve.engine import GenerationServer

    _, model = _bench_model(device, MOE_BENCH)
    srv = GenerationServer(model, n_slots=SERVE_SLOTS,
                           ticks_per_call=SERVE_TICKS,
                           admit_group=SERVE_GROUP, cache_len=SERVE_CACHE)
    ticks = []
    handle = model.register_forward_pre_hook(
        lambda _, args: ticks.append(1) if args[0].shape[1] == 1 else None)
    _reset_peak(device)
    before = _k1_launches()
    try:
        _, cold = serve_bench.run_pass(srv, requests // 4, SERVE_MAX_NEW,
                                       1338)
        srv.reset_stats()
        finished, wall = serve_bench.run_pass(srv, requests, SERVE_MAX_NEW,
                                              1337)
    finally:
        handle.remove()
    launches = _k1_launches() - before
    V = model.config.vocab_size
    if len(finished) != requests or any(
            len(r.generated) != r.max_new_tokens or not all(
                0 <= t < V for t in r.generated) for r in finished):
        raise AssertionError("MoE serving: a request did not finish with "
                             "its budget in range")
    cuda = torch.device(device).type == "cuda"
    if launches != (model.config.n_layer * len(ticks) if cuda else 0):
        raise AssertionError(f"MoE serving: {launches} K1 launches for "
                             f"{len(ticks)} ticks")
    tokens = sum(len(r.generated) for r in finished)
    latency = srv.latency_stats()
    peak = _peak_gib(device)
    print(f"MoE serving (bench config + 4 experts, {SERVE_SLOTS} slots, "
          f"cache_len {SERVE_CACHE}): cold pass {requests // 4} requests "
          f"{cold:.3f} s; hot pass {requests} requests, {tokens} tokens in "
          f"{wall:.3f} s = {tokens / wall:.1f} tok/s, latency {latency}, "
          f"phases {srv.stats}; {launches} K1 ring launches = n_layer x "
          f"{len(ticks)} ticks; peak {peak:.2f} GiB")
    return dict(tok_s=tokens / wall, latency=latency, launches=launches,
                peak_gib=peak)


def phase_moe_sample_cli(train, device) -> dict:
    """cli/sample.py from the trained MoE ckpt.pt: MOE_SAMPLES samples of
    the ``$X:`` prompt (the corpus's tune header after the CLI's marker)
    in one batch, 200 new tokens, T 0.8, top_k 200: one
    samples/sample_<i>.txt each, exactly n_layer x 201 K1 launches (the
    3-token prompt prefills 2 tokens).
    Returns samples/s and the launches."""
    import os
    import shutil

    from ai_music_generation_tpu_torch.cli import sample as cli
    from ai_music_generation_tpu_torch.experiments import moe_probe

    out = train["out_dir"]
    shutil.rmtree(os.path.join(out, "samples"), ignore_errors=True)
    before = _k1_launches()
    t0 = time.perf_counter()
    cli.main([f"--out_dir={out}", f"--data_root={train['data_root']}",
              f"--dataset={moe_probe.CORPUS}", "--tokens_format=char",
              "--use_validation_prefixes=False", "--start=$X:",
              f"--num_samples={MOE_SAMPLES}", f"--batch_size={MOE_SAMPLES}",
              f"--max_new_tokens={MOE_NEW}", "--temperature=0.8",
              "--top_k=200", f"--device={device}"])
    wall = time.perf_counter() - t0
    launches = _k1_launches() - before
    files = _sample_files(out)
    # the prompt's 3 tokens prefill at the power-of-two bucket of 2; every
    # later position is a T=1 step
    steps = len("$X:") + MOE_NEW - 2
    want = (MOE_GPT["n_layer"] * steps
            if torch.device(device).type == "cuda" else 0)
    if sorted(files) != sorted(f"sample_{i}.txt" for i in range(MOE_SAMPLES)) \
            or launches != want:
        raise AssertionError(f"MoE sample CLI: {len(files)} files, "
                             f"{launches} K1 launches (want {want})")
    print(f"MoE sample CLI from the trained ckpt.pt: {MOE_SAMPLES} samples x "
          f"{MOE_NEW} new tokens in {wall:.2f} s; {launches} K1 launches; "
          f"first: {files['sample_0.txt'][:80]!r}")
    return dict(samples_s=MOE_SAMPLES / wall, launches=launches)


# phase 41: the trainer's iterations (_iterations: CUDA events from the
# batch to the update) compared, the bf16 loss of each within
# MESH_LOSS_FRAC of the plain trainer's (one bf16 rounding of the value: at
# world size 1 the sharded step computes the same products, in a few other
# orders of fp32 sums)
MESH_ITERS, MESH_MOE_ITERS, MESH_WARMUP = 20, 10, 5
MESH_LOSS_FRAC = 2.0 ** -8


def _iterations(trainer, n: int) -> tuple[list, list]:
    """(losses, ms) of ``n`` iterations of the trainer's step from its
    ``iter_num`` on, each timed from its batch to its update: CUDA events
    on the card (one sync at the end), the host clock on the CPU."""
    cuda = trainer.device.type == "cuda"
    losses, marks = [], []
    for _ in range(n):
        x, y = trainer.get_batch("train", trainer.iter_num)
        start = (torch.cuda.Event(enable_timing=True) if cuda
                 else time.perf_counter())
        if cuda:
            start.record()
        metrics = trainer._train_step(x, y, trainer.iter_num,
                                      trainer.c["seed"])
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            float(metrics["loss"])
            end = time.perf_counter()
        losses.append(metrics["loss"])
        marks.append((start, end))
        trainer.iter_num += 1
    if cuda:
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in marks]
    else:
        ms = [(b - a) * 1e3 for a, b in marks]
    return [float(v) for v in losses], ms


def _close_losses(got, want, what) -> float:
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if not worst <= MESH_LOSS_FRAC:
        raise AssertionError(f"{what}: losses {got} vs the plain trainer's "
                             f"{want} (worst {worst:.3g} of the value)")
    return worst


def phase_mesh_train(device="cuda", iters=MESH_ITERS) -> dict:
    """Phase 41 (module docstring): the plain trainers first (no process
    group), then a group of one over NCCL and the sharded trainers; the
    group is left before returning. Returns the numbers."""
    import os
    import statistics

    import torch.distributed as dist

    from ai_music_generation_tpu_torch.experiments import moe_probe
    from ai_music_generation_tpu_torch.parallel import distributed
    from ai_music_generation_tpu_torch.train import checkpoint as ckpt_lib
    from ai_music_generation_tpu_torch.train.trainer import Trainer

    if dist.is_initialized():
        raise AssertionError("a process group is up before phase 41")
    with tempfile.TemporaryDirectory() as root:
        data_root = _cli_workspace(root)[0]
        music, _ = _music_arch(data_root)
        dense = dict(music, data_root=data_root, eval_interval=10 ** 9,
                     device=device, max_iters=iters)
        moe_data = os.path.join(root, "moe")
        moe_probe.write_corpus(moe_data)

        def moe(out, **kw):
            return moe_probe.trainer_config(
                moe_data, os.path.join(root, out), MESH_MOE_ITERS, True,
                device, eval_interval=10 ** 9, **kw)

        # one more plain iteration: the resumed trainers' first
        plain = _iterations(Trainer(dict(
            dense, out_dir=os.path.join(root, "plain"))), iters + 1)
        plain_moe = _iterations(Trainer(moe("plain-moe")), MESH_MOE_ITERS)
        torch.cuda.empty_cache()
        with distributed.group_of_one(device) as info:
            backend = dist.get_backend()
            out = os.path.join(root, "fsdp")
            trainer = Trainer(dict(dense, out_dir=out, fsdp=True))
            if trainer.plan is None or not trainer.plan.fsdp:
                raise AssertionError("the sharded trainer has no FSDP plan")
            fsdp = _iterations(trainer, iters)
            trainer._save(ckpt_lib.LAST)
            del trainer
            torch.cuda.empty_cache()
            resumed = Trainer(dict(dense, out_dir=out, init_from="resume",
                                   max_iters=iters + 1))
            state, opt = resumed.plan.gather_state(resumed.model,
                                                   resumed.optimizer)
            saved = ckpt_lib.load_checkpoint(out, ckpt_lib.LAST)
            if resumed.iter_num != iters or any(
                    not torch.equal(saved["model"][k], state[k])
                    for k in saved["model"]) or any(
                    not torch.equal(v, opt["state"][i][k])
                    for i, e in saved["optimizer"]["state"].items()
                    for k, v in e.items()):
                raise AssertionError("the resume with fsdp off did not "
                                     "restore the checkpoint bit for bit")
            after = _iterations(resumed, 1)
            del resumed
            torch.cuda.empty_cache()
            sharded_moe = Trainer(moe("mesh-moe"))
            if not sharded_moe.model.transformer.h[0].moe.layout:
                raise AssertionError("the MoE layers have no mesh layout")
            mesh_moe = _iterations(sharded_moe, MESH_MOE_ITERS)
            del sharded_moe
        torch.cuda.empty_cache()
    errs = {
        "dense": _close_losses(fsdp[0], plain[0][:iters], "FSDP + TP plan"),
        "resume": _close_losses(after[0], plain[0][iters:],
                                "resumed with fsdp off"),
        "moe": _close_losses(mesh_moe[0], plain_moe[0], "MoE, EP plan"),
    }

    def median(ms):
        return statistics.median(ms[MESH_WARMUP:])

    res = dict(backend=backend, world=info["process_count"], errs=errs,
               plain_ms=median(plain[1][:iters]), mesh_ms=median(fsdp[1]),
               plain_moe_ms=median(plain_moe[1]),
               mesh_moe_ms=median(mesh_moe[1]), losses=fsdp[0])
    print(f"mesh training ({backend}, world size {res['world']}): music "
          f"config, {iters} iterations, FSDP2 + the TP plan over a model "
          f"axis of 1 vs the plain trainer: losses within {errs['dense']:.3g}"
          f" of their value; resumed with fsdp off: bit-equal state, next "
          f"loss within {errs['resume']:.3g}; MoE (4 experts, EP plan) "
          f"{MESH_MOE_ITERS} iterations within {errs['moe']:.3g}; ms/iter "
          f"plain {res['plain_ms']:.3f} vs sharded {res['mesh_ms']:.3f} "
          f"(MoE {res['plain_moe_ms']:.3f} vs {res['mesh_moe_ms']:.3f})")
    return res


# phase 42: the rest of the parallel paths at world size 1, in a group of
# one over NCCL joined in this process (as phase 41): the sharded
# GenerationServer at phase 19's serving configuration and load, the
# sharded TunesServer (the reference model at phase 27's 1,024 slots over
# the requests of its cold pass: cli/serve_bench.py's tunes protocol, 1,024
# requests at 32 patches, seeds 10,000 + i), the sharded render of phase 32's tunes, and the pipeline and
# sequence train steps on the music config (phase 41's widths, dropout 0)
# for MESH_STEPS steps of a MESH_STEP_B x block_size batch against the
# plain step (optax_adamw at MESH_LR, no clip), each loss within
# MESH_LOSS_FRAC of its value
MESH_STEPS, MESH_STEP_B, MESH_MICRO, MESH_LR = 6, 16, 4, 1e-3


def _served(srv, n, seed):
    """(tokens by request id, generated tokens, wall s) of one pass of
    cli/serve_bench.py's load."""
    from ai_music_generation_tpu_torch.cli import serve_bench

    finished, wall = serve_bench.run_pass(srv, n, SERVE_MAX_NEW, seed)
    return ({r.id: r.generated for r in finished},
            sum(len(r.generated) for r in finished), wall)


# the timed passes of phase 42's servers, each engine's cold pass first:
# (engine, load seed), one a server (the script's time limit)
MESH_TURNS = (("mesh", 0), ("plain", 0))
# the sharded server's hot passes: half of phase 19's load (the script's
# time limit)
MESH_SERVE_REQUESTS = 4096


@torch.inference_mode()
def phase_mesh_serve(device="cuda", n_slots=SERVE_SLOTS,
                     requests=MESH_SERVE_REQUESTS) -> dict:
    """Phase 42's GenerationServer: the unsharded engine and the engine
    over ``make_mesh(1, 1)`` (the control plane of serve/mesh.py, the
    model's mesh parts, the token gather) over the same weights, each
    through phase 19's cold pass, then a hot pass each (MESH_TURNS): every
    request's tokens equal. K1's launches on the
    sharded engine's passes (its count set to 0 just before each, read just
    after) must be > 0. Returns the mean tok/s of each engine's hot passes
    and those launches."""
    import statistics

    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update
    from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
    from ai_music_generation_tpu_torch.serve.engine import GenerationServer

    kw = dict(n_slots=n_slots, ticks_per_call=SERVE_TICKS,
              admit_group=SERVE_GROUP, cache_len=SERVE_CACHE)
    kind = torch.device(device).type
    srv = {name: GenerationServer(_bench_model(device)[1], **kw, mesh=mesh)
           for name, mesh in (("plain", None),
                              ("mesh", make_mesh(1, 1, kind)))}
    tokens = {name: [] for name in srv}
    tok_s = {name: [] for name in srv}
    launches = 0
    turns = [(name, None) for name in srv] + list(MESH_TURNS)
    for name, turn in turns:
        gqa_decode_update.launches = 0
        if turn is None:  # the cold pass
            out = _served(srv[name], n_slots, 1338)
        else:
            out = _served(srv[name], requests, 1337 + 2 * turn)
            tok_s[name].append(out[1] / out[2])
        if name == "mesh":
            launches += gqa_decode_update.launches
        tokens[name].append(out[0])
    srv["mesh"].shutdown()
    del srv
    _empty_cache(device)
    if tokens["mesh"] != tokens["plain"]:
        raise AssertionError("the sharded server's tokens differ from the "
                             "unsharded server's")
    if kind == "cuda" and not launches:
        raise AssertionError("the sharded server launched no K1")
    res = dict(plain_tok_s=statistics.mean(tok_s["plain"]),
               mesh_tok_s=statistics.mean(tok_s["mesh"]), launches=launches,
               passes=tok_s)
    print(f"sharded serving (mesh 1x1): {n_slots} slots, a cold pass of "
          f"{n_slots} and a hot pass of {requests} requests each, every "
          f"request's tokens equal to the unsharded server's; "
          f"hot passes {res['mesh_tok_s']:.1f} tok/s vs unsharded "
          f"{res['plain_tok_s']:.1f} (each: {tok_s}); K1 launches on the "
          f"sharded passes {launches}")
    return res


@torch.inference_mode()
def phase_mesh_tunes(device="cuda", n_slots=TUNES_SLOTS,
                     max_patch=TUNES_MAX_PATCH) -> dict:
    """Phase 42's TunesServer: the unsharded server and the server over
    ``make_mesh(1, 1)``, each over the reference model's init weights,
    through phase 27's cold pass (``n_slots`` requests of
    cli/serve_bench.py's tunes protocol, seeds 10,000 + i), then through a
    hot pass of ``n_slots`` more each (MESH_TURNS, seeds 20,000 + i): every
    text equal. Returns the mean tunes/min of each
    server's timed passes."""
    import statistics

    from ai_music_generation_tpu_torch.cli import serve_bench
    from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
    from ai_music_generation_tpu_torch.serve.tunes_engine import TunesServer

    kind = torch.device(device).type
    srv = {name: TunesServer(_tunes_model(device)[1], n_slots=n_slots,
                             mesh=mesh)
           for name, mesh in (("plain", None),
                              ("mesh", make_mesh(1, 1, kind)))}
    texts = {name: [] for name in srv}
    rates = {name: [] for name in srv}
    turns = [(name, None) for name in srv] + list(MESH_TURNS)
    for name, turn in turns:
        seed0 = 10_000 if turn is None else 20_000 + 10_000 * turn
        finished, wall = serve_bench.run_tunes_pass(srv[name], n_slots,
                                                    max_patch, seed0)
        texts[name].append({r.id: r.text for r in finished})
        if turn is not None:
            rates[name].append(n_slots / wall * 60)
    srv["mesh"].shutdown()
    del srv
    _empty_cache(device)
    if texts["mesh"] != texts["plain"] or any(
            len(t) != n_slots for t in texts["plain"]):
        raise AssertionError("the sharded TunesServer's texts differ from "
                             "the unsharded server's")
    res = dict(plain=statistics.mean(rates["plain"]),
               mesh=statistics.mean(rates["mesh"]), passes=rates)
    print(f"sharded TunesServer (mesh 1x1): {n_slots} slots, phase 27's "
          f"cold pass and a pass of {n_slots} requests each at "
          f"{max_patch} patches, every text equal to the unsharded server's;"
          f" {res['mesh']:.1f} tunes/min vs unsharded {res['plain']:.1f} "
          f"(each: {rates})")
    return res


def phase_mesh_synth(device="cuda", n_tunes=SYNTH_BATCH) -> dict:
    """Phase 42's render: ``synthesize_midi_batch`` of phase 32's tunes
    over ``make_mesh(1, 1)`` bit-equal to the unsharded render."""
    import numpy as np

    from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
    from ai_music_generation_tpu_torch.synth.render import (
        synthesize_midi_batch,
    )

    midis = _synth_corpus(n_tunes)
    want = synthesize_midi_batch(midis, device=device)
    got = synthesize_midi_batch(
        midis, mesh=make_mesh(1, 1, torch.device(device).type), device=device)
    if len(got) != len(want) or not all(
            np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("the sharded render differs from the unsharded "
                             "render")
    print(f"sharded render (mesh 1x1): {n_tunes} tunes bit-equal to the "
          f"unsharded render")
    return dict(tunes=n_tunes, samples=sum(len(w) for w in want))


def _timed_steps(step, batches, device) -> tuple[list, list]:
    """(losses, ms) of ``step(x, y)`` over the batches: CUDA events on the
    card (one sync at the end), the host clock on the CPU."""
    cuda = torch.device(device).type == "cuda"
    losses, marks = [], []
    for x, y in batches:
        start = (torch.cuda.Event(enable_timing=True) if cuda
                 else time.perf_counter())
        if cuda:
            start.record()
        loss = step(x, y)
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            float(loss)
            end = time.perf_counter()
        losses.append(loss)
        marks.append((start, end))
    if cuda:
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in marks]
    else:
        ms = [(b - a) * 1e3 for a, b in marks]
    return [float(v) for v in losses], ms


def phase_mesh_steps(device="cuda", steps=MESH_STEPS, B=MESH_STEP_B) -> dict:
    """Phase 42's train steps: the music config at full width (dropout 0)
    from one init, the plain step (train/step.py, optax_adamw, no clip)
    against ``make_pipeline_train_step`` over ``make_pipe_mesh(1, 1)`` (one
    stage of every block, MESH_MICRO microbatches) and
    ``make_seq_train_step`` over ``make_seq_mesh(1, 1)`` (the ring
    attention over one chunk), on the same batches: each loss within
    MESH_LOSS_FRAC of the plain step's. Returns ms/step of the three."""
    import statistics

    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
    from ai_music_generation_tpu_torch.parallel.pipeline import (
        PipelineGPT, make_pipe_mesh, make_pipeline_train_step,
    )
    from ai_music_generation_tpu_torch.parallel.sequence import (
        make_seq_mesh, make_seq_train_step,
    )
    from ai_music_generation_tpu_torch.train.optimizer import optax_adamw
    from ai_music_generation_tpu_torch.train.step import make_train_step

    kind = torch.device(device).type
    with tempfile.TemporaryDirectory() as root:
        _, arch = _music_arch(_cli_workspace(root, n_val=8)[0])
    cfg = GPTConfig(**dict(arch, dropout=0.0))
    base = init_weights(GPT(cfg, device=device),
                        torch.Generator(device).manual_seed(0))
    state = {k: v.clone() for k, v in base.state_dict().items()}
    del base
    g = torch.Generator(device).manual_seed(1)
    x = torch.randint(0, cfg.vocab_size, (steps, B, cfg.block_size),
                      generator=g, device=device)
    batches = list(zip(x, x.roll(-1, dims=-1)))

    def lr(_):
        return MESH_LR

    def plain_model():
        model = GPT(cfg, device=device)
        model.load_state_dict(state)
        return model

    model = plain_model()
    step = make_train_step(model, optax_adamw(model.parameters()), lr, None)
    plain = _timed_steps(lambda a, b: step(a[None], b[None], 0)["loss"],
                         batches, device)
    mesh = make_pipe_mesh(1, 1, kind)
    stage = PipelineGPT(cfg, mesh, device=device)
    stage.load_plain(state)
    step = make_pipeline_train_step(stage, optax_adamw(stage.parameters()),
                                    mesh, MESH_MICRO, lr)
    pipe = _timed_steps(lambda a, b: step(a, b)["loss"], batches, device)
    model = plain_model()
    step = make_seq_train_step(model, optax_adamw(model.parameters()),
                               make_seq_mesh(1, 1, kind), lr)
    seq = _timed_steps(lambda a, b: step(a, b)["loss"], batches, device)
    del model, stage, step
    _empty_cache(device)
    errs = {"pipeline": _close_losses(pipe[0], plain[0], "pipeline step"),
            "sequence": _close_losses(seq[0], plain[0], "sequence step")}

    def median(ms):
        return statistics.median(ms[1:])

    res = dict(errs=errs, plain_ms=median(plain[1]), pipe_ms=median(pipe[1]),
               seq_ms=median(seq[1]), losses=plain[0])
    print(f"pipeline and sequence steps (meshes 1x1): music config, {steps} "
          f"steps of {B} x {cfg.block_size}, losses within {errs} of the "
          f"plain step's; ms/step plain {res['plain_ms']:.3f}, pipeline "
          f"({MESH_MICRO} microbatches) {res['pipe_ms']:.3f}, sequence "
          f"{res['seq_ms']:.3f}")
    return res


# GPT-2 import (phase 43): a random-init GPT-2 124M (HF's layout and names:
# 12 layers, 12 heads, 768 wide, vocab 50257, 1024 positions) written as a
# local directory the CLIs load by the name GPT2_NAME (init_from routes on
# the "gpt2" prefix, relative to the working directory); sampled at
# GPT2_B prompts of PROMPT_LEN tokens, 500 new tokens, T 0.8, top_k 200
# (the CLI's defaults); evaluated with configs/eval_gpt2.py and fine-tuned
# with configs/finetune_shakespeare.py on a corpus of random ids
GPT2_NAME, GPT2_SEED = "gpt2-random", 11
GPT2 = dict(n_layer=12, n_head=12, n_embd=768, vocab_size=50257,
            n_positions=1024)
GPT2_B, GPT2_NEW, GPT2_ROWS, GPT2_STEPS = 256, 500, 4, 16
GPT2_EVAL_ITERS, GPT2_FT_ITERS, GPT2_FT_ACCUM = 20, 5, 2
GPT2_CORPUS = 2_000_000
EVAL_GPT2_CONFIG = "ai_music_generation_tpu_torch/configs/eval_gpt2.py"
FINETUNE_CONFIG = "ai_music_generation_tpu_torch/configs/finetune_shakespeare.py"
# the replay harness (phase 44): fixtures made from a seed
REPLAY_TUNES, REPLAY_BACH, REPLAY_WAVS, REPLAY_BPE_VOCAB = 1000, 200, 4, 1000


def _write_hf_gpt2(path, seed=GPT2_SEED) -> int:
    """A random-init GPT-2 124M in HF's layout: ``config.json`` and
    ``model.safetensors`` (written by the safetensors package, so the
    port's own reader is held to the format's writer) with the hub file's
    names (no ``transformer.`` prefix, Conv1D weights [in, out], each
    block's causal-mask buffer ``attn.bias``), from a seeded numpy
    generator: weights N(0, 0.02)
    (the residual projections 0.02 / sqrt(2 L), as HF's init), biases N(0,
    0.02) and LayerNorm weights 1 + N(0, 0.1) so that a misplaced one shows.
    Returns the parameter count."""
    import os

    import numpy as np
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    L, C = GPT2["n_layer"], GPT2["n_embd"]
    V, P = GPT2["vocab_size"], GPT2["n_positions"]

    def normal(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def ln():
        return 1.0 + normal(C, std=0.1), normal(C)

    mask = np.tril(np.ones((P, P), np.float32))[None, None]
    t = {"wte.weight": normal(V, C), "wpe.weight": normal(P, C, std=0.01)}
    for i in range(L):
        h = f"h.{i}."
        t[h + "ln_1.weight"], t[h + "ln_1.bias"] = ln()
        t[h + "attn.bias"] = mask
        t[h + "attn.c_attn.weight"] = normal(C, 3 * C)
        t[h + "attn.c_attn.bias"] = normal(3 * C)
        t[h + "attn.c_proj.weight"] = normal(C, C, std=0.02 / (2 * L) ** 0.5)
        t[h + "attn.c_proj.bias"] = normal(C)
        t[h + "ln_2.weight"], t[h + "ln_2.bias"] = ln()
        t[h + "mlp.c_fc.weight"] = normal(C, 4 * C)
        t[h + "mlp.c_fc.bias"] = normal(4 * C)
        t[h + "mlp.c_proj.weight"] = normal(4 * C, C,
                                            std=0.02 / (2 * L) ** 0.5)
        t[h + "mlp.c_proj.bias"] = normal(C)
    t["ln_f.weight"], t["ln_f.bias"] = ln()
    os.makedirs(path, exist_ok=True)
    save_file(t, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(architectures=["GPT2LMHeadModel"], model_type="gpt2",
                       n_ctx=P, activation_function="gelu_new",
                       layer_norm_epsilon=1e-5, **GPT2), f)
    return sum(a.size for k, a in t.items() if not k.endswith(".attn.bias"))


def _gpt2_workspace(root) -> dict:
    """The GPT-2 directory and a uint16 corpus of GPT2_CORPUS random ids
    below the vocabulary (90/10 train/val, no meta.pkl: the trainer takes
    the HF vocabulary) under ``root``."""
    import os

    import numpy as np

    from ai_music_generation_tpu_torch.data.memmap import write_bin

    n = _write_hf_gpt2(os.path.join(root, GPT2_NAME))
    ids = np.random.default_rng(GPT2_SEED).integers(
        0, GPT2["vocab_size"], GPT2_CORPUS).astype(np.uint16)
    data = os.path.join(root, "data", "randtok")
    os.makedirs(data)
    split = int(0.9 * len(ids))
    write_bin(ids[:split], os.path.join(data, "train.bin"), np.uint16)
    write_bin(ids[split:], os.path.join(data, "val.bin"), np.uint16)
    print(f"GPT-2 workspace: {GPT2_NAME}/ ({n:,} parameters, HF layout, "
          f"safetensors), {GPT2_CORPUS:,} random ids")
    return dict(root=root, data_root=os.path.join(root, "data"),
                n_params=n)


@torch.inference_mode()
def phase_gpt2_model(ws, device="cuda") -> dict:
    """``cli/sample.py::load_model(init_from=GPT2_NAME)`` on the card (bf16,
    the CLI's default) and on the CPU in fp32: a prefill of PROMPT_LEN
    tokens and GPT2_STEPS decode steps teacher-forced at B = GPT2_B on the
    card (K1 at every step) against GPT2_ROWS rows on the CPU, logits within
    the phase-4 yardstick (2^-4 of their range). Returns the CPU model (the
    fine-tune's loss is held against it) and the error."""
    import contextlib

    from ai_music_generation_tpu_torch.cli.sample import load_model
    from ai_music_generation_tpu_torch.models.gpt import KVCache

    with contextlib.chdir(ws["root"]):
        t0 = time.perf_counter()
        model, meta = load_model("out", init_from=GPT2_NAME, device=device)
        load_s = time.perf_counter() - t0
        cpu, _ = load_model("out", dtype="float32", init_from=GPT2_NAME,
                            device="cpu")
    cfg = model.config
    want_cfg = dict(GPT2, block_size=GPT2["n_positions"])
    del want_cfg["n_positions"]
    got_cfg = {k: getattr(cfg, k) for k in want_cfg}
    if got_cfg != want_cfg or meta != {"model_args": {}, "config": {}}:
        raise AssertionError(f"GPT-2 loaded as {got_cfg}, meta {meta}")
    if model.num_params(non_embedding=False) != ws["n_params"]:
        raise AssertionError("GPT-2 parameter count")
    g = torch.Generator().manual_seed(GPT2_SEED)
    ids = torch.randint(0, cfg.vocab_size, (GPT2_B, PROMPT_LEN + GPT2_STEPS),
                        generator=g, dtype=torch.int32)
    S = cfg.block_size
    caches = (KVCache.create(cfg, GPT2_B, S, device=device),
              KVCache.create(cpu.config, GPT2_ROWS, S, device="cpu"))
    worst, rng = 0.0, 0.0
    for lo, hi in [(0, PROMPT_LEN)] + [
            (t, t + 1) for t in range(PROMPT_LEN, PROMPT_LEN + GPT2_STEPS)]:
        got, _ = model(ids[:, lo:hi].to(device), cache=caches[0])
        want, _ = cpu(ids[:GPT2_ROWS, lo:hi], cache=caches[1])
        got = got[:GPT2_ROWS].float().cpu()
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite GPT-2 logits on the card")
        err = (got - want).abs().max().item()
        rng = max(rng, want.abs().max().item())
        if not err <= 2.0 ** -4 * rng:
            raise AssertionError(f"GPT-2 logits differ by {err} > "
                                 f"{2.0 ** -4 * rng} at {lo}")
        worst = max(worst, err)
    print(f"GPT-2 124M from {GPT2_NAME}/ via cli/sample.py::load_model on "
          f"{device} in {load_s:.1f} s (bf16) and on the CPU (fp32): prefill "
          f"{PROMPT_LEN} + {GPT2_STEPS} decode steps at B={GPT2_B}, "
          f"{GPT2_ROWS} rows vs CPU: logits max abs err {worst} = "
          f"{worst / rng:.3e} of the range (tol 2^-4)")
    del model, caches
    _empty_cache(device)
    return dict(cpu=cpu, err=worst / rng)


def phase_gpt2_kernel(B=GPT2_B, S=GPT2["n_positions"]) -> tuple[dict, set]:
    """K1 at GPT-2 124M's decode step (B rows, MHA H = KH = 12, D = 64, bf16
    cache of S columns, lockstep): held against the twin at pos 0, 128
    (the second tile of columns), PROMPT_LEN + GPT2_NEW - 1 (the last step
    the sampling path runs) and S-1 (caches bit-exact, out within one bf16
    ulp of its range of the twin in fp32), then timed with the twin (plain, kernel, kernel, plain)
    at pos S-1 (every column valid) beside ``scaled_dot_product_attention``
    over the same columns (attention only: no column write). Returns (the
    JSON numbers, the (B, S, KH*D, dtype, ring) checked)."""
    import torch.nn.functional as F

    from ai_music_generation_tpu_torch.ops.gqa_decode import (
        gqa_decode_reference, gqa_decode_update,
    )

    H, D = GPT2["n_head"], GPT2["n_embd"] // GPT2["n_head"]
    worst = 0.0
    # one set of inputs (a lockstep step's depend on pos only through the
    # column it writes and the columns it reads), fresh copies per check
    cpu = _decode_inputs(False, False, S - 1, B, S, H=H, KH=H, seed=3)
    checked = (0, 128, PROMPT_LEN + GPT2_NEW - 1, S - 1)
    for pos in checked:
        err, _ = _check_k1(_to(cpu, "cuda"), [a if a is None else a.clone()
                                              for a in cpu], pos, "cuda",
                           f"GPT-2 shape pos={pos}")
        worst = max(worst, err)
    x = _to(cpu, "cuda")
    p = torch.tensor(S - 1, dtype=torch.int32, device="cuda")
    qs = x[0][:, :, None, :].contiguous()
    ks, vs = (t.view(B, S, H, D).transpose(1, 2).contiguous()
              for t in x[1:3])
    kernel, plain = _timed(lambda: gqa_decode_update(*x, p),
                           lambda: gqa_decode_reference(*x, p), 50, 10)
    library = [_cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs),
                        50) for _ in range(2)]
    bound_ms, bound_by = _k1_tunes_bound(x, S - 1)
    ms = min(kernel)
    print(f"K1 at the GPT-2 decode step (B={B}, S={S}, H=KH={H}, D={D}, "
          f"bf16, lockstep): vs twin at pos {checked}: caches bit-exact, out "
          f"max abs err {worst}; kernel {kernel} ms, twin {plain} ms (plain, "
          f"kernel, kernel, plain); SDPA (attention only) {library} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it")
    return (dict(ms=ms, plain_ms=min(plain), bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=min(library),
                 max_abs_err=worst),
            {(B, S, H * D, torch.bfloat16, False)})


@torch.inference_mode()
def phase_gpt2_main_path(ws, device="cuda"):
    """``Generator`` over ``load_model(init_from=GPT2_NAME)`` (what
    cli/sample.py's run_sampling runs after encoding: tiktoken's table
    cannot be fetched without a network) at GPT2_B prompts of PROMPT_LEN
    random ids, GPT2_NEW new tokens, T 0.8, top_k 200, the default window
    (block_size 1024), twice at one seed: shape, prompts kept, tokens in
    range, identical runs, and exactly n_layer x GPT2_NEW K1 launches a
    generate: the 8-token prefill runs no K1, then positions 8 .. 507 are
    one T=1 step each (the last feeds the final token, as every generate
    does), 500 steps x 12 layers = 6,000; no refresh (508 <= 1024).
    Returns (generator, prompts, launches a generate)."""
    import contextlib

    from ai_music_generation_tpu_torch.cli.sample import DEFAULTS, load_model
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update

    with contextlib.chdir(ws["root"]):
        model, _ = load_model("out", init_from=GPT2_NAME, device=device)
    cfg = model.config
    gen = Generator(model, max_new_tokens=GPT2_NEW,
                    temperature=DEFAULTS["temperature"],
                    top_k=DEFAULTS["top_k"])
    prompts = torch.randint(0, cfg.vocab_size, (GPT2_B, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(2),
                            dtype=torch.int32)
    runs, seconds = [], []
    for _ in range(2):
        before = gqa_decode_update.launches
        t0 = time.perf_counter()
        out = gen.generate(prompts, seed=1234)
        _sync(device)
        seconds.append(round(time.perf_counter() - t0, 3))
        runs.append((out.cpu(), gqa_decode_update.launches - before))
    (out, launches), (again, launches2) = runs
    want = cfg.n_layer * GPT2_NEW if torch.device(device).type == "cuda" \
        else 0
    if out.shape != (GPT2_B, PROMPT_LEN + GPT2_NEW) or not torch.equal(
            out[:, :PROMPT_LEN], prompts):
        raise AssertionError(f"GPT-2 generate: shape {tuple(out.shape)}")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("GPT-2 token out of range")
    if not torch.equal(out, again):
        raise AssertionError("GPT-2: same seed gave different tokens")
    if not launches == launches2 == want:
        raise AssertionError(f"GPT-2 K1 launches per generate {launches}, "
                             f"{launches2} != {want}")
    print(f"GPT-2 main path: generate [{GPT2_B}, {PROMPT_LEN}] -> "
          f"{tuple(out.shape)}, prompts kept, tokens in range, same seed "
          f"identical, {launches} K1 launches per generate ({cfg.n_layer} "
          f"layers x {GPT2_NEW} steps); {seconds} s (host clock)")
    return gen, prompts, launches


def _gpt2_profiled():
    """(run, unprofiled wall s, description) of phase 43's generate to
    profile, after a warm run."""
    import contextlib

    from ai_music_generation_tpu_torch.cli.sample import load_model
    from ai_music_generation_tpu_torch.decode.generate import Generator

    with tempfile.TemporaryDirectory() as tmp:
        _gpt2_workspace(tmp)
        with contextlib.chdir(tmp):
            model, _ = load_model("out", init_from=GPT2_NAME, device="cuda")
    gen = Generator(model, max_new_tokens=GPT2_NEW, temperature=0.8,
                    top_k=200)
    prompts = torch.randint(0, model.config.vocab_size, (GPT2_B, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(6),
                            dtype=torch.int32)
    gen.generate(prompts, seed=1)
    wall = _event_seconds(lambda: gen.generate(prompts, seed=2))
    return (lambda: gen.generate(prompts, seed=3), wall,
            f"GPT-2 124M, B={GPT2_B}, {GPT2_NEW} new tokens, window "
            f"{gen.window}")


def phase_gpt2_train(ws, cpu, device="cuda") -> dict:
    """``cli/train.py configs/eval_gpt2.py --init_from=GPT2_NAME
    --eval_iters=GPT2_EVAL_ITERS`` (eval_only, batch 8 x 1024) on the
    random-id corpus: both losses finite. Then ``cli/train.py
    configs/finetune_shakespeare.py --init_from=GPT2_NAME`` (batch 1,
    block_size 1024 = n_positions, lr 3e-5 constant, bf16) on it for
    GPT2_FT_ITERS iterations at accum GPT2_FT_ACCUM: every loss finite, and
    the iter-0 loss within TRAIN_STEP_FRAC[bf16] of its value of the CPU's
    fp32 loss on the same batch (the trainer's first batch, drawn as it
    draws it). Returns the numbers."""
    import contextlib
    import math
    import os

    from ai_music_generation_tpu_torch.cli import train as train_cli
    from ai_music_generation_tpu_torch.data.memmap import BinDataset
    from ai_music_generation_tpu_torch.train.trainer import DEFAULTS

    common = [f"--init_from={GPT2_NAME}", "--dataset=randtok",
              f"--data_root={ws['data_root']}", f"--device={device}"]
    eval_out = os.path.join(ws["root"], "eval-gpt2")
    ft_out = os.path.join(ws["root"], "finetune-gpt2")
    configs = [os.path.abspath(p) for p in (EVAL_GPT2_CONFIG,
                                            FINETUNE_CONFIG)]
    with contextlib.chdir(ws["root"]):
        t0 = time.perf_counter()
        _tee(train_cli.main, [configs[0], *common,
                              f"--eval_iters={GPT2_EVAL_ITERS}",
                              f"--out_dir={eval_out}"])
        eval_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        log = _tee(train_cli.main, [
            configs[1], *common, f"--max_iters={GPT2_FT_ITERS}",
            f"--eval_interval={GPT2_FT_ITERS}", "--eval_iters=2",
            f"--gradient_accumulation_steps={GPT2_FT_ACCUM}",
            "--log_interval=1", f"--out_dir={ft_out}"])
        ft_s = time.perf_counter() - t0
    with open(os.path.join(eval_out, "losses.jsonl")) as f:
        evals = [json.loads(line) for line in f]
    losses = [(i, loss) for i, _, _, loss in _iter_lines(log)]
    if (len(evals) != 1 or not all(math.isfinite(evals[0][k])
                                   for k in ("train/loss", "val/loss"))
            or [i for i, _ in losses] != list(range(GPT2_FT_ITERS + 1))
            or not all(math.isfinite(v) for _, v in losses)):
        raise AssertionError(f"GPT-2 eval {evals}, fine-tune {losses}")
    ds = BinDataset(os.path.join(ws["data_root"], "randtok", "train.bin"))
    x, y = (torch.from_numpy(a) for a in ds.sharded_sample(
        DEFAULTS["seed"], 0, (GPT2_FT_ACCUM, 1), DEFAULTS["block_size"],
        (0, 1)))
    with torch.no_grad():
        want = sum(float(cpu(x[i], y[i])[1]) for i in range(GPT2_FT_ACCUM)
                   ) / GPT2_FT_ACCUM
    got = losses[0][1]
    frac = TRAIN_STEP_FRAC[torch.bfloat16]
    if not abs(got - want) <= frac * abs(want):
        raise AssertionError(f"GPT-2 iter-0 loss {got} on the card vs "
                             f"{want} on the CPU (fp32)")
    print(f"GPT-2 eval (configs/eval_gpt2.py, {GPT2_EVAL_ITERS} x batch 8 x "
          f"1024): train loss {evals[0]['train/loss']:.4f}, val loss "
          f"{evals[0]['val/loss']:.4f} (ln V = "
          f"{math.log(GPT2['vocab_size']):.4f}) in {eval_s:.1f} s; "
          f"fine-tune (configs/finetune_shakespeare.py, accum "
          f"{GPT2_FT_ACCUM} x 1 x 1024): losses {losses} in {ft_s:.1f} s; "
          f"iter-0 loss {got} vs the CPU's fp32 {want:.6f} (tol {frac:.3g} "
          f"of it)")
    return dict(eval=evals[0], losses=losses, cpu_loss=want,
                eval_s=eval_s, ft_s=ft_s)


def phase_gpt2_sizing() -> float:
    """utils/sizing.py's report for GPT-2 124M and its training tokens/s at
    40% MFU of the card's peak (models/gpt.py::peak_flops_for). Returns
    that peak."""
    from ai_music_generation_tpu_torch.models.gpt import (
        GPTConfig, peak_flops_for,
    )
    from ai_music_generation_tpu_torch.utils import sizing

    cfg = GPTConfig(block_size=GPT2["n_positions"],
                    vocab_size=GPT2["vocab_size"], n_layer=GPT2["n_layer"],
                    n_head=GPT2["n_head"], n_embd=GPT2["n_embd"])
    peak = peak_flops_for("cuda")
    sizing.print_report(cfg)
    print(f"projected training at 40% MFU of {peak / 1e12:.0f} TFLOP/s: "
          f"{sizing.projected_tokens_per_sec(cfg, 0.4, peak=peak):,.0f} "
          f"tokens/s")
    return peak


def _replay_fixtures(root) -> dict:
    """phase 44's inputs under ``root`` and the goldens they imply, each
    counted here from its recipe: IrishMAN-style JSON (random tunes:
    entries stripped, " $" appended, space-joined, char vocab) for the
    irishman and leadsheet stages; Bach-style midi-text directories (a
    "$ " per piece, whitespace tokens, the vocab a union with an extra
    corpus); a weights.pth of the reference TunesFormer written by the
    port's exporter from a seeded init; phase 34's seeded Audiobox
    checkpoint and REPLAY_WAVS WAVs (seeded tones and noise of 3.7-25 s);
    an encoder.json/vocab.bpe of a byte-level BPE trained by ``tokenizers``
    on the tunes, with an input.txt whose token counts ``tokenizers``
    gives."""
    import os
    import random

    import numpy as np
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )
    from ai_music_generation_tpu_torch.models.convert import (
        init_tunesformer_weights,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        TunesFormer, TunesFormerConfig,
    )
    from ai_music_generation_tpu_torch.models.tunesformer_export import (
        save_reference_checkpoint,
    )
    from ai_music_generation_tpu_torch.synth.wav_io import write_wav

    f, goldens = {}, {}
    tunes = random_tunes(REPLAY_TUNES, seed=SYNTH_SEED)
    for stage, lo, hi in (("irishman", 0, REPLAY_TUNES),
                          ("leadsheet", 0, REPLAY_TUNES // 4)):
        part = tunes[lo:hi]
        n_val = len(part) // 10
        splits = {"train": part[n_val:], "valid": part[:n_val]}
        text = {}
        for name, rows in splits.items():
            f[f"{stage}_{name}"] = os.path.join(root, f"{stage}_{name}.json")
            with open(f[f"{stage}_{name}"], "w") as fh:
                json.dump([{"abc notation": "\n " + t + " \n"}
                           for t in rows], fh)
            text[name] = " ".join(t.strip() + " $" for t in rows)
        goldens[f"{stage}_char"] = {
            "vocab": len(set(text["train"] + text["valid"])),
            "train_tokens": len(text["train"]),
            "val_tokens": len(text["valid"])}
    rng = random.Random(SYNTH_SEED)

    def piece():
        return " | ".join(" ".join(
            f"p{rng.randint(40, 90)} d{rng.choice((1, 2, 4, 8))} "
            f"o{rng.randint(0, 16)}" for _ in range(rng.randint(2, 6)))
            for _ in range(rng.randint(4, 12)))

    texts, vocab = {}, set()
    for name, n in (("train", REPLAY_BACH), ("valid", REPLAY_BACH // 10),
                    ("extra", REPLAY_BACH // 10)):
        d = f[f"bach_{name}"] = os.path.join(root, "bach", name)
        os.makedirs(d)
        texts[name] = [piece() for _ in range(n)]
        for i, t in enumerate(texts[name]):
            with open(os.path.join(d, f"{i:04d}.txt"), "w") as fh:
                fh.write(t)
        vocab |= {w for t in texts[name] for w in ("$ " + t).split()}
    count = {k: sum(len(("$ " + t).split()) for t in texts[k])
             for k in ("train", "valid")}
    goldens["bach_midi"] = {"vocab": len(vocab),
                            "train_tokens": count["train"],
                            "val_tokens": count["valid"]}
    cfg = TunesFormerConfig()
    f["weights"] = os.path.join(root, "weights.pth")
    save_reference_checkpoint(f["weights"], init_tunesformer_weights(
        TunesFormer(cfg, device="cpu"), torch.Generator().manual_seed(
            SYNTH_SEED)))
    goldens["tunesformer"] = {"patch_layers": cfg.patch_layers,
                              "char_layers": cfg.char_layers,
                              "n_embd": cfg.n_embd,
                              "patch_size": cfg.patch_size}
    f["audiobox"] = os.path.join(root, "audiobox.pt")
    _audiobox_checkpoint(f["audiobox"], _audiobox_config())
    wav_rng = np.random.default_rng(AUDIOBOX_SEED)
    f["wav_jsonl"] = os.path.join(root, "wavs.jsonl")
    with open(f["wav_jsonl"], "w") as fh:
        for i, seconds in enumerate((3.7, 10.0, 12.5, 25.0)[:REPLAY_WAVS]):
            t = np.arange(int(seconds * 16_000)) / 16_000
            wave = (0.3 * np.sin(2 * np.pi * 110 * (i + 2) * t)
                    + 0.05 * wav_rng.standard_normal(len(t)))
            path = os.path.join(root, f"tone{i}.wav")
            write_wav(path, wave.astype(np.float32))
            fh.write(json.dumps({"path": path}) + "\n")
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(tunes, trainers.BpeTrainer(
        vocab_size=REPLAY_BPE_VOCAB,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    state = json.loads(tok.to_str())
    f["bpe"] = os.path.join(root, "bpe")
    os.makedirs(f["bpe"])
    with open(os.path.join(f["bpe"], "encoder.json"), "w") as fh:
        json.dump(state["model"]["vocab"], fh)
    with open(os.path.join(f["bpe"], "vocab.bpe"), "w") as fh:
        fh.write("#version: 0.2\n" + "\n".join(
            m if isinstance(m, str) else " ".join(m)
            for m in state["model"]["merges"]) + "\n")
    text = "\n\n".join(tunes)
    f["input_txt"] = os.path.join(root, "input.txt")
    with open(f["input_txt"], "w", encoding="utf-8") as fh:
        fh.write(text)
    split = int(len(text) * 0.9)
    goldens["shakespeare_gpt2"] = {
        "train_tokens": len(tok.encode(text[:split]).ids),
        "val_tokens": len(tok.encode(text[split:]).ids)}
    f["goldens"] = os.path.join(root, "goldens.json")
    with open(f["goldens"], "w") as fh:
        json.dump(goldens, fh)
    return f


def phase_replay(root, device="cuda") -> dict:
    """``cli/replay_goldens.py --device cuda`` over ``_replay_fixtures``
    with their ``--goldens`` file: every stage with inputs PASSes
    (irishman and leadsheet char, bach midi, the TunesFormer arch and
    bridge, the Audiobox keys on the card with every WAV scored finite,
    the GPT-2 BPE prepare); the audio-aes parity leg, abc2midi and
    fluidsynth SKIP with JAX's reasons unless their binaries are present;
    exit 0. Returns the statuses and the wall time."""
    import math
    import os
    import shutil

    from ai_music_generation_tpu_torch.cli import replay_goldens

    t0 = time.perf_counter()
    fx = _replay_fixtures(root)
    fixtures_s = time.perf_counter() - t0
    out = os.path.join(root, "replay")
    argv = ["--irishman_train", fx["irishman_train"],
            "--irishman_valid", fx["irishman_valid"],
            "--leadsheet_train", fx["leadsheet_train"],
            "--leadsheet_valid", fx["leadsheet_valid"],
            "--bach_train_dir", fx["bach_train"],
            "--bach_valid_dir", fx["bach_valid"],
            "--bach_extra_vocab_dirs", fx["bach_extra"],
            "--tunesformer_weights", fx["weights"],
            "--audiobox_ckpt", fx["audiobox"], "--wav_jsonl", fx["wav_jsonl"],
            "--shakespeare_txt", fx["input_txt"], "--bpe_assets", fx["bpe"],
            "--goldens", fx["goldens"], "--out_dir", out,
            "--device", device]
    binaries = {name: shutil.which(name) for name in ("abc2midi",
                                                      "fluidsynth")}
    t0 = time.perf_counter()
    rc = replay_goldens.main(argv)
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "replay_report.json")) as fh:
        rows = {r["stage"]: r["status"] for r in json.load(fh)}
    with open(os.path.join(out, "audiobox_ours.jsonl")) as fh:
        scores = [json.loads(line) for line in fh]
    must = {s: "PASS" for s in (
        "irishman_char", "leadsheet_char", "bach_midi", "tunesformer_arch",
        "tunesformer_bridge", "audiobox_keys", "shakespeare_gpt2")}
    must.update({s: "SKIP" for s, b in (("abc2midi_diff", "abc2midi"),
                                        ("fluidsynth_ab", "fluidsynth"))
                 if binaries[b] is None})
    if shutil.which("audio-aes") is None:
        must["audiobox_parity"] = "SKIP"
    bad = {s: rows.get(s) for s, want in must.items() if rows.get(s) != want}
    if rc != 0 or bad or "FAIL" in rows.values() or len(scores) != \
            REPLAY_WAVS or not all(math.isfinite(v) for r in scores
                                   for v in r.values()):
        raise AssertionError(f"replay: exit {rc}, {rows}, off {bad}, "
                             f"scores {scores}")
    print(f"replay_goldens --device {device}: exit {rc}, {rows}; fixtures "
          f"{fixtures_s:.1f} s, the harness {wall:.1f} s")
    return dict(rows=rows, wall=wall, fixtures_s=fixtures_s)


# the last host entry points (phase 45): cli/transfer_experiment.py at its
# defaults (:73-85: 400 melodies, 120 chorales, 4L/4H/256d, block 256,
# batch 32, dropout 0.1, bf16, an eval of 20 batches every 100 iterations)
# but its 600 pretrain and 300 fine-tune iterations, cut to 300 and 200
# for the script's time limit, on the card, then each host CLI once on
# fixtures made from a seed
TRANSFER_ITERS = {"--pretrain_iters": 300, "--finetune_iters": 200,
                  "--eval_interval": 100}
HOST_CHORALES, HOST_MELODIES, HOST_XML = 24, 40, 8
HOST_PIECES_PER_SIG, HOST_GENERATED = 10, 4
HOST_BASELINES = 1000  # random_baselines' default --num_files
HOST_HANG_S = 300  # a hung pool ends the script with its traceback


def phase_transfer(root, device="cuda", flags=()) -> dict:
    """``cli/transfer_experiment.py`` with ``--device``, TRANSFER_ITERS (and
    ``flags``: none on the card, a tiny model in a CPU rehearsal) in
    ``root``, its ``--doc_out`` there too: the three legs finish at their
    iterations (melody 0 -> 300, transfer 300 -> 500, resumed from the
    melody checkpoint, scratch 0 -> 200), every val loss finite. The verdict
    (transfer beats scratch or not) is recorded, not gated. ms/iter of a
    leg: the median of its log lines whose 50-iteration window holds no
    eval. Returns the best val losses, the verdict, ms/iter per leg and
    the wall time."""
    import math
    import os
    import re
    import statistics

    from ai_music_generation_tpu_torch.cli import transfer_experiment

    it = dict(TRANSFER_ITERS)
    for flag in flags:
        name, _, value = flag.partition("=")
        if name in it:
            it[name] = int(value)
    pre, fine = it["--pretrain_iters"], it["--finetune_iters"]
    w = os.path.join(root, "transfer")
    doc = os.path.join(root, "transfer.md")
    t0 = time.perf_counter()
    log = _tee(transfer_experiment.main, [
        f"--work_dir={w}", f"--doc_out={doc}", f"--device={device}",
        *(f"{k}={v}" for k, v in it.items()),
        *(f for f in flags if f.partition("=")[0] not in it)])
    wall = time.perf_counter() - t0
    spans = {"melody": (0, pre), "transfer": (pre, pre + fine),
             "scratch": (0, fine)}
    best, ms = {}, {}
    for (leg, (first, last)), part in zip(spans.items(),
                                          log.split("== leg ")[1:]):
        with open(os.path.join(w, f"out_{leg}", "losses.jsonl")) as fh:
            evals = [json.loads(line) for line in fh]
        iters = [r["iter"] for r in evals]
        if (iters[0] != first or iters[-1] != last
                or not all(math.isfinite(r["val/loss"]) for r in evals)):
            raise AssertionError(f"transfer experiment, {leg} leg: evals "
                                 f"{evals}, expected iterations {first} to "
                                 f"{last} with finite losses")
        best[leg] = min(r["val/loss"] for r in evals)
        steady = [m for i, m, _, _ in _iter_lines(part)
                  if i != first and i % it["--eval_interval"]]
        ms[leg] = statistics.median(steady) if steady else float("nan")
    verdict = re.search(r"transfer (beats|does NOT beat) scratch", log)
    with open(doc) as fh:
        row = fh.read()
    if verdict is None or f"| {verdict.group(1)} |" not in row:
        raise AssertionError(f"transfer experiment: no verdict ({row!r})")
    print(f"transfer experiment ({device}): best val loss melody "
          f"{best['melody']:.4f}, transfer {best['transfer']:.4f}, scratch "
          f"{best['scratch']:.4f}: transfer {verdict.group(1)} scratch; "
          f"ms/iter {ms}; {wall:.1f} s")
    return dict(best=best, verdict=verdict.group(1), ms=ms, wall=wall)


def _host_files(d, suffix, n, what) -> list:
    """The ``suffix`` files of ``d``: exactly ``n``, none empty."""
    import os

    names = sorted(f for f in os.listdir(d) if f.endswith(suffix))
    empty = [f for f in names if os.path.getsize(os.path.join(d, f)) == 0]
    if len(names) != n or empty:
        raise AssertionError(f"{what}: {len(names)} {suffix} files in {d} "
                             f"(expected {n}), empty: {empty}")
    return names


def _host_musicxml(d, n, seed=SYNTH_SEED) -> None:
    """``n`` one-part MusicXML files of seeded notes, rests and chords in
    4/4, 3/4 or 6/8 and a key of -5..5 fifths (the last one zipped as
    .mxl), and one malformed file."""
    import os
    import random
    import zipfile

    rng = random.Random(seed)
    os.makedirs(d)
    for i in range(n):
        beats, beat_type = rng.choice([(4, 4), (3, 4), (6, 8)])
        units = 4 * beats * 2 // beat_type  # divisions 2
        measures = []
        for m_idx in range(rng.randint(2, 6)):
            notes, left = [], units
            while left:
                dur = rng.randint(1, min(left, 4))
                if rng.random() < 0.2:
                    notes.append(f"<note><rest/><duration>{dur}</duration>"
                                 "</note>")
                else:
                    for c in range(rng.choice([1, 1, 1, 3])):
                        notes.append(
                            f"<note>{'<chord/>' if c else ''}<pitch><step>"
                            f"{rng.choice('CDEFGAB')}</step><alter>"
                            f"{rng.choice([-1, 0, 0, 1])}</alter><octave>"
                            f"{rng.randint(3, 5)}</octave></pitch><duration>"
                            f"{dur}</duration></note>")
                left -= dur
            attrs = (f"<attributes><divisions>2</divisions><key><fifths>"
                     f"{rng.randint(-5, 5)}</fifths></key><time><beats>"
                     f"{beats}</beats><beat-type>{beat_type}</beat-type>"
                     "</time></attributes>" if m_idx == 0 else "")
            measures.append(f'<measure number="{m_idx + 1}">{attrs}'
                            + "".join(notes) + "</measure>")
        xml = ('<?xml version="1.0"?><score-partwise><work><work-title>'
               f"Tune {i}</work-title></work><part-list><score-part "
               'id="P1"/></part-list><part id="P1">' + "".join(measures)
               + "</part></score-partwise>")
        if i == n - 1:
            with zipfile.ZipFile(os.path.join(d, f"tune{i}.mxl"), "w") as z:
                z.writestr("score.xml", xml)
        else:
            with open(os.path.join(d, f"tune{i}.xml"), "w") as fh:
                fh.write(xml)
    with open(os.path.join(d, "broken.xml"), "w") as fh:
        fh.write("<not-musicxml/>")


def phase_host_clis(root) -> dict:
    """Each host entry point once, on fixtures made from a seed, every
    output file present and non-empty in its expected count:
    ``bach_pipeline`` synthesize-corpus (HOST_CHORALES + 3 blacklisted)
    -> ground-truth -> split (90/10) -> score-templates ->
    measure-templates -> generate (HOST_GENERATED); ``midi_to_text
    --processes=2`` on the chorales -> ``text_to_midi``; ``build_
    synthetic_4parts`` on the midi-texts of HOST_MELODIES soprano lines
    (``midi_to_text --processes=2``), HOST_PIECES_PER_SIG a meter with 4
    melodies or more; ``batch_convert_xml --processes=2`` on HOST_XML
    MusicXML files (one .mxl) and a malformed one; ``random_baselines`` in
    its four modes at its default 1,000 files; ``python -m
    ai_music_generation_tpu_torch run`` in a fresh interpreter over a copy
    of the repository's ``conf/`` and ``data/01_raw/``. The pools fork from
    this process, which holds a CUDA context; none of these modules imports
    torch. Returns the file counts and the wall time."""
    import faulthandler
    import os
    import re
    import shutil

    from ai_music_generation_tpu_torch.cli import (
        bach_pipeline,
        batch_convert_xml,
        build_synthetic_4parts,
        midi_to_text,
        random_baselines,
        text_to_midi,
    )
    from ai_music_generation_tpu_torch.codec import midi_io
    from ai_music_generation_tpu_torch.codec.score import Score, score_to_midi
    from ai_music_generation_tpu_torch.data.chorales import synthesize_chorale

    def p(*parts):
        return os.path.join(root, "host", *parts)

    n, counts = HOST_CHORALES, {}
    t0 = time.perf_counter()
    faulthandler.dump_traceback_later(HOST_HANG_S, exit=True)
    try:
        bach_pipeline.main(["synthesize-corpus", f"--out_dir={p('raw')}",
                            f"--num_pieces={n}", "--seed=0"])
        _host_files(p("raw"), ".mid", n + 3, "synthesize-corpus")
        bach_pipeline.main(["ground-truth", p("raw"), f"--out_dir={p('gt')}"])
        counts["ground-truth"] = len(_host_files(p("gt"), ".mid", n,
                                                 "ground-truth"))
        bach_pipeline.main(["split", p("gt"), f"--out_dir={p('split')}"])
        n_train = int(n * 0.9)
        counts["split"] = (
            len(_host_files(p("split", "train"), ".mid", n_train, "split")),
            len(_host_files(p("split", "validation"), ".mid", n - n_train,
                            "split")))
        bach_pipeline.main(["score-templates", p("gt"),
                            f"--out_dir={p('stats')}"])
        _host_files(p("stats"), ".json", 3, "score-templates")
        bach_pipeline.main(["measure-templates", p("gt"),
                            f"--out_dir={p('stats')}"])
        _host_files(p("stats"), ".json", 6, "measure-templates")
        bach_pipeline.main(["generate", p("stats"), f"--out_dir={p('gen')}",
                            f"--num_pieces={HOST_GENERATED}"])
        counts["generate"] = len(_host_files(p("gen"), ".mid",
                                             HOST_GENERATED, "generate"))

        if midi_to_text.main([p("gt"), p("texts"), "--processes=2"]) != (
                n, 0):
            raise AssertionError("midi_to_text failed on a chorale")
        counts["midi_to_text"] = len(_host_files(p("texts"), ".txt", n,
                                                 "midi_to_text"))
        if text_to_midi.main([p("texts"), p("back")]) != (n, 0):
            raise AssertionError("text_to_midi failed on a chorale text")
        counts["text_to_midi"] = len(_host_files(p("back"), ".mid", n,
                                                 "text_to_midi"))

        os.makedirs(p("melodies"))
        for i in range(HOST_MELODIES):
            score = synthesize_chorale(SYNTH_SEED * 1_000 + i)
            midi_io.write_midi_file(score_to_midi(Score(parts=score.parts[:1])),
                                    p("melodies", f"mel{i:03d}.mid"))
        midi_to_text.main([p("melodies"), p("melody_texts"), "--processes=2"])
        meters = collections.Counter()
        for name in _host_files(p("melody_texts"), ".txt", HOST_MELODIES,
                                "midi_to_text (melodies)"):
            with open(p("melody_texts", name)) as fh:
                meters[re.search(r"time_signature_(\d+/\d+)",
                                 fh.read()).group(1)] += 1
        pieces = HOST_PIECES_PER_SIG * sum(c >= 4 for c in meters.values())
        if build_synthetic_4parts.main([
                p("melody_texts"), p("pieces"),
                f"--pieces_per_sig={HOST_PIECES_PER_SIG}"]) != pieces:
            raise AssertionError("build_synthetic_4parts: wrong piece count")
        counts["build_synthetic_4parts"] = len(_host_files(
            p("pieces"), ".txt", pieces, "build_synthetic_4parts"))

        _host_musicxml(p("xml"), HOST_XML)
        if batch_convert_xml.main([p("xml"), p("abc"), "--processes=2"]) != (
                HOST_XML, 1):
            raise AssertionError("batch_convert_xml: wrong counts")
        abc = _host_files(p("abc"), ".abc", HOST_XML, "batch_convert_xml")
        for name in abc:
            with open(p("abc", name)) as fh:
                if not fh.read().startswith("X:"):
                    raise AssertionError(f"batch_convert_xml: {name} is not "
                                         f"ABC")
        counts["batch_convert_xml"] = len(abc)

        val = p("validation.json")
        with open(val, "w") as fh:
            json.dump([{"abc notation": t} for t in
                       random_baselines.random_tunes(50, seed=SYNTH_SEED)], fh)
        for mode in ("random", "repeated", "repeated_measures",
                     "sampled_measures"):
            if random_baselines.main([mode, p(mode), "--validation_json",
                                      val]) != HOST_BASELINES:
                raise AssertionError(f"random_baselines {mode}: wrong count")
            counts[mode] = len(_host_files(p(mode), ".abc", HOST_BASELINES,
                                           f"random_baselines {mode}"))

        repo = os.path.dirname(os.path.abspath(__file__))
        shutil.copytree(os.path.join(repo, "conf"), p("project", "conf"))
        shutil.copytree(os.path.join(repo, "data", "01_raw"),
                        p("project", "data", "01_raw"))
        proc = subprocess.run(
            [sys.executable, "-m", "ai_music_generation_tpu_torch", "run"],
            cwd=p("project"), capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": repo})
        if proc.returncode != 0 or "pipeline '__default__' completed" \
                not in proc.stdout:
            raise AssertionError(f"python -m ai_music_generation_tpu_torch "
                                 f"run: exit {proc.returncode}\n"
                                 f"{proc.stdout}{proc.stderr}")
        counts["python -m run"] = len(_host_files(
            p("project", "data", "02_preprocessed"), ".csv", 1,
            "python -m ai_music_generation_tpu_torch run"))
    finally:
        faulthandler.cancel_dump_traceback_later()
    wall = time.perf_counter() - t0
    print(f"host entry points: {counts}; {wall:.1f} s")
    return dict(counts=counts, wall=wall)


# the trained-model decode studies (phase 46): experiments/{realpath_bench_r5,
# realpath_window_r5,window64_probe,int8_quality,gqa_quality,spec_decode,
# spec_trace,serve_soak}.py at full width (decode_studies.Sizes: 6L/6H/384d,
# block 256, 3,000 tunes, 500 new tokens, 64 quality generations), each
# training cut to STUDY_ITERS iterations, one timed generate a leg, the
# 1,000-sample CLI leg alone, spec_trace without the profiler and the soak
# cut to STUDY_WAVES waves (the full protocols run through python -m,
# PERF.md); the timed generates at STUDY_BATCH rows, a quarter of the
# protocol's 4,096, for the script's time limit, but spec_trace's (its
# int8_dots verify step is the shape phase 46 times at B=4096); then
# parallel/worker_smoke.py over NCCL at world size 1
STUDY_ITERS, STUDY_WAVES, STUDY_BATCH = 300, 3, 1024
SPEC_TRACE_T = 8  # spec_trace's verify step: n_draft 7 + 1


def _study_counts(result, path, spec=False, n_layer=BENCH["n_layer"]):
    """Hold one generate's counts (decode_studies.StepCount) to the path:
    a plain path launches K1 once a layer a T=1 step and no K2; a spec path
    K2, no K1."""
    for c in result if isinstance(result, list) else [result]:
        ok = (c["k1"] == 0 and c["k2"] > 0 if spec else
              c["t1_steps"] > 0 and c["k1"] == n_layer * c["t1_steps"]
              and c["k2"] == 0)
        if not ok:
            raise AssertionError(f"{path}: launches {c} (n_layer "
                                 f"{n_layer}, {'spec' if spec else 'plain'})")


def phase_studies(root, device="cuda", iters=STUDY_ITERS, waves=STUDY_WAVES,
                  sizes=None, soak=None) -> dict:
    """Every study's ``run`` in ``root`` (trainings shared as the harness
    shares them: the KH=2 flagship trained by realpath_bench_r5, MHA by
    int8_quality, the spec model by spec_decode; the others reuse them),
    each printed as its JSON line, and the gates: every training's val loss
    falls, every teacher NLL is finite, every plain generate and CLI run
    launches n_layer x its T=1 steps of K1 (no K2), every spec generate K2
    and no K1 (spec_trace's int8_dots variant included), the soak's
    accounting holds (its run raises otherwise) with its ticks on K1; then
    worker_smoke over NCCL at world size 1. ``sizes`` / ``soak`` override
    the study sizes and the soak's arguments (a CPU rehearsal)."""
    import dataclasses
    import math
    import os

    from ai_music_generation_tpu_torch.experiments import (
        decode_studies as ds,
        gqa_quality,
        int8_quality,
        realpath_bench_r5,
        realpath_window_r5,
        serve_soak,
        spec_decode,
        spec_trace,
        window64_probe,
    )
    from ai_music_generation_tpu_torch.parallel.worker_smoke import (
        launch_multiprocess_smoke,
    )

    full = sizes or ds.Sizes(iters=iters, reps=1, samples=(1000,))
    sizes = dataclasses.replace(full, batch=min(full.batch, STUDY_BATCH))
    steps = (
        ("realpath_bench_r5", lambda: realpath_bench_r5.run(
            root, sizes, device)),
        ("realpath_window_r5", lambda: realpath_window_r5.run(
            root, sizes, device, reuse=True)),
        ("window64_probe", lambda: window64_probe.run(
            root, sizes, device, reuse=True)),
        ("int8_quality", lambda: int8_quality.run(root, sizes, device)),
        ("gqa_quality", lambda: gqa_quality.run(root, sizes, device,
                                                reuse=True)),
        ("spec_decode", lambda: spec_decode.run(root, sizes, device)),
        ("spec_trace", lambda: spec_trace.run(root, full, device,
                                              reuse=True, profile=False)),
        ("serve_soak", lambda: serve_soak.run(
            device, **(soak or dict(waves=waves)))),
    )
    res, walls = {}, {}
    for name, run in steps:
        t0 = time.perf_counter()
        res[name] = ds.print_result(run())
        walls[name] = time.perf_counter() - t0
        _empty_cache(device)
    n_layer = sizes.n_layer
    for name, r in res.items():
        trains = r.get("train", {})
        for t in trains.values() if "history" not in trains else [trains]:
            first, last = t["history"][0][2], t["history"][-1][2]
            if not (math.isfinite(last) and last < first):
                raise AssertionError(f"{name}: the val loss did not fall: "
                                     f"{t['history']}")
        for leg in (r, r.get("window"), r.get("quality")):
            nll = leg.get("teacher_nll") if isinstance(leg, dict) else None
            if nll and not all(math.isfinite(v) for v in nll.values()):
                raise AssertionError(f"{name}: teacher NLL {nll}")
    rb, rw = res["realpath_bench_r5"], res["realpath_window_r5"]
    for name, legs in (("realpath_bench_r5", rb["cli"]),
                       ("realpath_window_r5", rw["cli"])):
        for leg in legs:
            for run in ("cold", "warm"):
                _study_counts(leg[run]["counts"], f"{name} CLI {run}",
                              n_layer=n_layer)
    _study_counts(rb["microbench"]["counts"], "realpath microbench",
                  n_layer=n_layer)
    _study_counts(res["window64_probe"]["throughput"]["counts"],
                  "window64 throughput", n_layer=n_layer)
    for name in ("int8_quality", "gqa_quality"):
        for leg, t in res[name]["throughput"].items():
            _study_counts(t["counts"], f"{name} {leg}", n_layer=n_layer)
    sd = res["spec_decode"]
    _study_counts(sd["plain"]["counts"], "spec_decode plain",
                  n_layer=n_layer)
    for k, t in sd["spec"].items():
        _study_counts(t["counts"], f"spec_decode n_draft {k}", spec=True)
    st = res["spec_trace"]
    _study_counts(st["plain"]["counts"], "spec_trace plain", n_layer=n_layer)
    for leg in ("bf16_k7", "int8dots_k7"):
        _study_counts(st[leg]["counts"], f"spec_trace {leg}", spec=True)
    for w in res["serve_soak"]["waves"]:
        _study_counts(w["counts"], f"serve_soak wave {w['wave']}",
                      n_layer=n_layer)
    t0 = time.perf_counter()
    smoke = launch_multiprocess_smoke(os.path.join(root, "worker_smoke"),
                                      num_processes=1, timeout=300,
                                      device=device)[0]
    walls["worker_smoke"] = time.perf_counter() - t0
    if not (smoke["process_count"] == smoke["n_devices"] == 1
            and math.isfinite(smoke["loss"]) and smoke["psum"] == 0.0
            and smoke["main_flags"] == ["main_flag_0"]):
        raise AssertionError(f"worker_smoke over {device}: {smoke}")
    print(f"worker_smoke ({device}, world size 1): {json.dumps(smoke)}")
    print(f"studies: walls {json.dumps(walls)}")
    return dict(results=res, walls=walls, smoke=smoke)


# a verify step of spec_trace's over a shorter history: its live history
# columns (the generate's histories run from its 8-token prompts to S-8)
INT8_DOTS_MID = 120
INT8_DOTS_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/spec_attention_dots.cu"


def phase_int8_dots_timing(B=BATCH, S=256, H=6, D=64, T=SPEC_TRACE_T) -> dict:
    """K2's int8_dots mode (the integer tensor-core mode of
    csrc/spec_attention_mma.cuh) at spec_trace's verify step (B=4096, S=256,
    T=8, cursor S-8, every history column live), with a bf16 q and with a
    full fp32 one, against its twin (write_slab + the int8_dots reference)
    in fp32: the write bit-exact, the output within 2^-6 of its largest
    value (phase 6's yardstick). Then timed in the order plain, kernel,
    kernel, plain, the fp32-q kernel and K2's bf16-dot int8 mode (the
    mode the bf16 models run) on the same inputs timed beside the kernel.
    Then the same gate and the kernel, its twin and the bf16-dot mode timed
    at a verify step over INT8_DOTS_MID live history columns (cursor
    there) and at a refresh (T=128 at cursor 0, no history). Its bound: the
    bytes, or the int8 x int8 products at 1979 TOP/s; no one PyTorch call
    computes it."""
    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention_int8_dots_reference, spec_attention_update,
        write_slab,
    )

    x = _spec_inputs(True, T, S - 8, B, S, H, D, seed=2, device="cuda",
                     n_live=S - 8)
    g = torch.Generator(device="cuda").manual_seed(3)
    xf = dict(x, q=torch.randn(x["q"].shape, generator=g, device="cuda"))

    def plain(x):
        write_slab(x["k"], x["v"], x["k_slab"], x["v_slab"], x["cursor"])
        return spec_attention_int8_dots_reference(
            *[x[n] for n in SPEC_ATT], n_head=H)

    def kernel(x, dots=True):
        return spec_attention_update(*[x[n] for n in SPEC_UPD], n_head=H,
                                     int8_dots=dots)

    errs, spans = {}, {}

    def check(y, label):
        ref_k, ref_v = y["k"].clone(), y["v"].clone()
        got = kernel(y)
        write_slab(ref_k, ref_v, y["k_slab"], y["v_slab"], y["cursor"])
        if not (torch.equal(y["k"], ref_k) and torch.equal(y["v"], ref_v)):
            raise AssertionError(f"int8_dots ({label}): the cache write "
                                 f"differs")
        want = spec_attention_int8_dots_reference(
            y["q"].float(), ref_k, ref_v, *[y[n] for n in SPEC_ATT[3:]],
            n_head=H)
        errs[label] = float((got.float() - want).abs().max())
        spans[label] = float(want.abs().max())
        if errs[label] > 2.0 ** -6 * spans[label]:
            raise AssertionError(f"int8_dots ({label}): error {errs[label]}"
                                 f" > 2^-6 of {spans[label]}")

    check(x, "bf16")
    check(xf, "fp32")  # x and xf share the caches
    runs = {"plain": (lambda: plain(x), 5), "kernel": (lambda: kernel(x), 20),
            "fp32": (lambda: kernel(xf), 20),
            "bf16_dot": (lambda: kernel(x, dots=False), 20)}
    ms = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            fn, iters = runs[name]
            ms[name].append(_cuda_ms(fn, iters))
    bound_ms, bound_by = bound(*_spec_work(x, T, S - 8, H, True),
                               INT8_OPS_PER_S)
    fp32_bound, _ = bound(*_spec_work(xf, T, S - 8, H, True),
                          INT8_OPS_PER_S)
    del x, xf

    def beside(T, cursor, n_live, iters, seed):
        """The kernel, its twin and the bf16-dot mode at one more shape,
        timed as above; with its bound."""
        y = _spec_inputs(True, T, cursor, B, S, H, D, seed=seed,
                         device="cuda", n_live=n_live)
        check(y, f"T={T} cursor {cursor}")
        runs = {"plain": (lambda: plain(y), 2),
                "kernel": (lambda: kernel(y), iters),
                "bf16_dot": (lambda: kernel(y, dots=False), iters)}
        ms = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                fn, n = runs[name]
                ms[name].append(_cuda_ms(fn, n))
        b_ms, b_by = bound(*_spec_work(y, T, cursor, H, True),
                           INT8_OPS_PER_S)
        return ms, b_ms, b_by

    mms, m_bound, m_by = beside(T, INT8_DOTS_MID, INT8_DOTS_MID, 20, 5)
    # the refresh (T=128 at cursor 0 over an empty history)
    rms, r_bound, r_by = beside(128, 0, 0, 10, 4)
    r = dict(route="cuda", source=INT8_DOTS_SOURCE,
             ms=min(ms["kernel"]), plain_ms=min(ms["plain"]),
             bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
             max_abs_err=errs["bf16"], bf16_dot_ms=min(ms["bf16_dot"]),
             fp32=dict(ms=min(ms["fp32"]), bound_ms=fp32_bound,
                       max_abs_err=errs["fp32"]),
             mid=dict(live=INT8_DOTS_MID, ms=min(mms["kernel"]),
                      plain_ms=min(mms["plain"]), bound_ms=m_bound,
                      bound_by=m_by, bf16_dot_ms=min(mms["bf16_dot"]),
                      max_abs_err=errs[f"T={T} cursor {INT8_DOTS_MID}"]),
             refresh=dict(ms=min(rms["kernel"]), plain_ms=min(rms["plain"]),
                          bound_ms=r_bound, bound_by=r_by,
                          bf16_dot_ms=min(rms["bf16_dot"]),
                          max_abs_err=errs["T=128 cursor 0"]))
    print(f"spec_attention_update int8_dots (B={B} S={S} T={T}, {S - 8} live"
          f" history columns), ms/call in the order plain, kernel, fp32 q, "
          f"bf16-dot and back: {ms}; error bf16 q {errs['bf16']:.3e} "
          f"(largest value {spans['bf16']:.3f}), fp32 q {errs['fp32']:.3e} "
          f"({spans['fp32']:.3f}); bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / r['ms']:.3f} of it (fp32 q: {fp32_bound:.4f}, "
          f"{fp32_bound / r['fp32']['ms']:.3f}); the bf16-dot mode "
          f"{r['bf16_dot_ms']:.4f} ms; over {INT8_DOTS_MID} live history "
          f"columns (cursor there) in the order plain, kernel, bf16-dot and "
          f"back: {mms}, bound {m_bound:.4f} ms ({m_by}), "
          f"{m_bound / r['mid']['ms']:.3f} of it; the refresh (T=128 at "
          f"cursor 0) the same: {rms}, bound "
          f"{r_bound:.4f} ms ({r_by}), {r_bound / r['refresh']['ms']:.3f} of"
          f" it")
    return r


# the last experiment scripts (phase 47): experiments/{window_quality,
# refresh_quality,window_flat_probe,mfu_sweep,fuzz_campaign,int4_probe,
# int4_probe2,int4_cache_probe}.py at full width in phase 46's work
# directory (window_quality reuses its spec checkpoint), trainings cut to
# STUDY_ITERS, one timed generate a leg at STUDY_BATCH rows, mfu_sweep at
# both models with every variant, the fuzz campaign at FUZZ_CASES, the
# probes at their full shapes (the full protocols run through python -m,
# PERF.md)
FUZZ_CASES = (5000, 500)  # ABC differential cases, codec round trips a mode
SUM_RATE_LIMIT = 1.05 * 3.35e3  # GB/s: no sum pass reads above the HBM rate


def phase_experiments(root, device="cuda", iters=STUDY_ITERS, sizes=None,
                      refresh_sizes=None, mfu=None, fuzz=FUZZ_CASES,
                      probes=None) -> dict:
    """Each module's ``run`` in ``root``, its JSON line printed, and the
    gates: every training's val loss falls, every NLL is finite, every
    generate launches n_layer x its T=1 steps of K1 and no other kernel,
    mfu_sweep launches none of K1-K7 with every variant's loss finite and
    MFU in (0, 1) and a big batch run, the fuzz campaign is clean, the int8
    and packed probe variants are timed and no sum pass reads above
    SUM_RATE_LIMIT. ``sizes``, ``refresh_sizes``, ``mfu`` (mfu_sweep.run's
    keyword arguments a model) and ``probes`` (each probe's) cut a CPU
    rehearsal."""
    import dataclasses
    import math

    from ai_music_generation_tpu_torch.experiments import (
        decode_studies as ds,
        fuzz_campaign,
        int4_cache_probe,
        int4_probe,
        int4_probe2,
        mfu_sweep,
        refresh_quality,
        window_flat_probe,
        window_quality,
    )

    sizes = sizes or ds.Sizes(iters=iters, reps=1, batch=STUDY_BATCH)
    refresh_sizes = refresh_sizes or dataclasses.replace(
        refresh_quality.SIZES, iters=iters, reps=1)
    probes = probes or {}
    ops = _counted_ops()
    res, walls, mfu_launches = {}, {}, {}

    def mfu_runs():
        out = {}
        for model in mfu_sweep.MODELS:
            before = {k: f.launches for k, f in ops.items()}
            out[model] = mfu_sweep.run(model, device=device,
                                       **(mfu or {}).get(model, {}))
            mfu_launches[model] = {k: f.launches - before[k]
                                   for k, f in ops.items()}
            _empty_cache(device)
        return out

    steps = (
        ("window_quality", lambda: window_quality.run(
            root, sizes, device, reuse=True)),
        ("refresh_quality", lambda: refresh_quality.run(
            root, refresh_sizes, device)),
        ("window_flat_probe", lambda: window_flat_probe.run(sizes, device)),
        ("mfu_sweep", mfu_runs),
        ("fuzz_campaign", lambda: fuzz_campaign.run(*fuzz)),
        ("int4_probe", lambda: int4_probe.run(
            device=device, **probes.get("int4_probe", {}))),
        ("int4_probe2", lambda: int4_probe2.run(
            device=device, **probes.get("int4_probe2", {}))),
        ("int4_cache_probe", lambda: int4_cache_probe.run(
            device=device, **probes.get("int4_cache_probe", {}))),
    )
    for name, run in steps:
        t0 = time.perf_counter()
        res[name] = run()
        for r in res[name].values() if name == "mfu_sweep" else [res[name]]:
            ds.print_result(r)
        walls[name] = time.perf_counter() - t0
        _empty_cache(device)
    wq, rq = res["window_quality"], res["refresh_quality"]
    for name, r in (("window_quality", wq), ("refresh_quality", rq)):
        hist = r["train"]["history"]
        first, last = hist[0][2], hist[-1][2]
        if not (math.isfinite(last) and last < first):
            raise AssertionError(f"{name}: the val loss did not fall: "
                                 f"{r['train']['history']}")
    for name, nll in (("window_quality", wq["teacher_nll"]),
                      ("refresh_quality", rq["nll_vs_context"])):
        if not all(math.isfinite(v) for v in nll.values()):
            raise AssertionError(f"{name}: NLL {nll}")
    for w, t in wq["throughput"].items():
        _study_counts(t["counts"], f"window_quality window {w}",
                      n_layer=sizes.n_layer)
    for r, t in rq["throughput"].items():
        _study_counts(t["counts"], f"refresh_quality refresh {r}",
                      n_layer=refresh_sizes.n_layer)
    for row in res["window_flat_probe"]["all"]:
        _study_counts(row["counts"], f"window_flat_probe {row['config']} "
                      f"window {row['window']}", n_layer=sizes.n_layer)
    for model, r in res["mfu_sweep"].items():
        if any(mfu_launches[model].values()):
            raise AssertionError(f"mfu_sweep {model} launched "
                                 f"{mfu_launches[model]}")
        for v, x in r["variants"].items():
            if not (math.isfinite(x["loss"]) and 0 < x["mfu"] < 1):
                raise AssertionError(f"mfu_sweep {model} {v}: {x}")
        if not any(x["batch"] != r["batch"] for x in r["variants"].values()):
            raise AssertionError(f"mfu_sweep {model}: no big batch ran "
                                 f"({r['big_failures']})")
    if not res["fuzz_campaign"]["clean"]:
        raise AssertionError(f"fuzz campaign: {res['fuzz_campaign']}")
    p1, p2, p3 = (res[k] for k in ("int4_probe", "int4_probe2",
                                   "int4_cache_probe"))
    timed = ([p1["variants"][k] for k in ("int8", "packed")]
             + [p2["cases"][f"{k}-{s}"] for k in ("attn", "sum")
                for s in ("int8", "packed")] + [p3["variants"]["int8"]])
    if not all(t.get("ms_per_call", 0) > 0 for t in timed):
        raise AssertionError(f"int4 probes: a variant was not timed: {timed}")
    for label, c in p2["cases"].items():
        if label.startswith("sum") and c.get("gb_s", 0) > SUM_RATE_LIMIT:
            raise AssertionError(f"int4_probe2 {label} reads {c['gb_s']:.0f}"
                                 f" GB/s, above {SUM_RATE_LIMIT:.0f}")
    print(f"experiments: walls {json.dumps(walls)}")
    return dict(results=res, walls=walls, mfu_launches=mfu_launches)


def _experiments_summary(er) -> str:
    """Phase 47's results in one line."""
    wq, rq, mfu = er["window_quality"], er["refresh_quality"], er["mfu_sweep"]
    return (
        f"experiments: window_quality NLL {wq['teacher_nll']}, tok/s "
        + ", ".join(f"{w} {t['tok_s']:.1f}"
                    for w, t in wq["throughput"].items())
        + f"; refresh_quality NLL vs context {rq['nll_vs_context']}, tok/s "
        + ", ".join(f"{r} {t['tok_s']:.1f}"
                    for r, t in rq["throughput"].items())
        + "; window x flat " + ", ".join(
            f"{row['config']} @{row['window']} {row['tok_s']:.1f}"
            for row in er["window_flat_probe"]["all"])
        + "; mfu_sweep " + "; ".join(
            f"{m}: " + ", ".join(f"{k} {v['ms']:.2f} ms {v['mfu']:.4f}"
                                 for k, v in r["variants"].items())
            for m, r in mfu.items())
        + f"; fuzz {er['fuzz_campaign']['abc']['cases']} ABC + "
        f"{er['fuzz_campaign']['codec']['cases']} codec cases clean; "
        "int4_probe ms/step " + ", ".join(
            f"{k} {v.get('ms_per_step', 'FAILED')}"
            for k, v in er["int4_probe"]["variants"].items())
        + "; int4_probe2 GB/s " + ", ".join(
            f"{k} {v['gb_s']:.0f}" if "gb_s" in v else f"{k} FAILED"
            for k, v in er["int4_probe2"]["cases"].items()))


def _empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _counted_ops() -> dict:
    """The wrappers of the port's K1-K7 by name; each counts its launches
    (the dropout kernel's ``dropout_apply`` is counted on its own)."""
    from ai_music_generation_tpu_torch.ops import decode_attention_int8 as i8
    from ai_music_generation_tpu_torch.ops.decode_attention import (
        decode_attention,
    )
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update
    from ai_music_generation_tpu_torch.ops.lean_attention import (
        lean_attention,
    )
    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention, spec_attention_update,
    )

    return {f.__name__: f for f in (
        gqa_decode_update, spec_attention_update, spec_attention,
        decode_attention, i8.decode_attention_int8,
        i8.decode_attention_int8_multirow, lean_attention)}


def _main_path(phase, *args):
    """Run a main-path phase with every kernel's launch count set to 0 just
    before it; returns the phase's result and the counts just after."""
    ops = _counted_ops()
    for f in ops.values():
        f.launches = 0
    result = phase(*args)
    return result, {name: f.launches for name, f in ops.items()}


def _entry(name, source, replaces, launches, err, numbers, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, **numbers, **extra)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", nargs="?", const="pallas",
                        metavar="PATHS",
                        help="only build, then profile one generate (train: "
                             "one train step at 124M and at the music "
                             "widths; tunes_train: one TunesFormer train "
                             "step at the reference config; synth: one "
                             "render batch of the eval pipeline; audiobox: "
                             "one forward of WavLM base at batch 10) of each "
                             f"of the comma-separated paths (of "
                             f"{', '.join(PROFILED)}; default pallas): no "
                             "checks, no JSON result")
    args = parser.parse_args(argv)
    if args.profile and not set(args.profile.split(",")) <= set(PROFILED):
        parser.error(f"--profile takes paths of {PROFILED}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    started = time.perf_counter()
    card = phase_environment()
    phase_build()
    if args.profile:
        for path in args.profile.split(","):
            if path == "train":
                phase_profile_train()
            elif path == "tunes_train":
                phase_profile_tunes_train()
            elif path == "synth":
                phase_profile_synth()
            elif path == "audiobox":
                phase_profile_audiobox()
            else:
                phase_profile(path)
            torch.cuda.empty_cache()
        return 0
    err = phase_kernel_vs_twin("cuda")
    k1 = phase_kernel_timing()
    phase_model("cuda")
    (gen, prompts, launches), on_path = _main_path(phase_main_path,
                                                   "cuda")
    tok_s = phase_throughput(gen, prompts)
    print(f"[{card}] decode {tok_s:.1f} tokens/s at batch {BATCH}, "
          f"{MAX_NEW} new tokens, window {WINDOW}; gqa_decode kernel "
          f"{k1['ms']:.4f} ms/call, plain twin {k1['plain_ms']:.4f} ms/call")
    kernels = [_entry("gqa_decode_update", KERNEL_SOURCE, KERNEL_REPLACES,
                      launches, err, k1)]
    del gen, prompts
    torch.cuda.empty_cache()

    ops = _counted_ops()
    ops["spec_attention"].launches = 0
    spec_err = phase_spec_kernel_vs_twin("cuda")
    k3_checks = ops["spec_attention"].launches
    spec_ms = phase_spec_kernel_timing()
    phase_spec_model("cuda")
    (gen, prompts, spec_launches, n_steps, per_step), counts = _main_path(
        phase_spec_main_path, "cuda")
    on_path = {k: n + counts[k] for k, n in on_path.items()}
    spec_tok_s = phase_spec_throughput(gen, prompts)
    verify, refresh = spec_ms["spec_attention_update"], spec_ms["refresh"]
    print(f"[{card}] spec decode {spec_tok_s['spec']:.1f} tokens/s "
          f"({per_step:.3f} committed tokens per step, {n_steps} steps) vs "
          f"plain {spec_tok_s['plain']:.1f} tokens/s on the SPEC model; "
          f"spec_attention_update {verify['ms']:.4f} ms/call at T=5 "
          f"(twin {verify['plain_ms']:.4f}), {refresh['ms']:.4f} ms at "
          f"T=128 (twin {refresh['plain_ms']:.4f})")
    kernels.append(_entry("spec_attention_update", SPEC_SOURCE,
                          SPEC_REPLACES["spec_attention_update"],
                          spec_launches, spec_err["spec_attention_update"],
                          verify, refresh=refresh))
    del gen, prompts
    torch.cuda.empty_cache()

    k4_err = phase_prefix_kernel_vs_twin("cuda")
    k4 = phase_prefix_kernel_timing()
    phase_model("cuda", config=PALLAS, window=None)
    (gen, prompts, k4_launches), counts = _main_path(phase_pallas_main_path,
                                                     "cuda")
    on_path = {k: n + counts[k] for k, n in on_path.items()}
    pallas_tok_s = phase_pallas_throughput(gen, prompts)
    print(f"[{card}] pallas decode {pallas_tok_s['pallas']:.1f} tokens/s vs "
          f"xla (K1) {pallas_tok_s['xla']:.1f} tokens/s at batch {BATCH}, "
          f"{MAX_NEW} new tokens, window 256; decode_attention "
          f"{k4[128]['ms']:.4f} ms/call at length 128, {k4[256]['ms']:.4f} "
          f"at 256")
    kernels.append(_entry("decode_attention", PREFIX_SOURCE,
                          PREFIX_REPLACES["decode_attention"], k4_launches,
                          k4_err, k4[256]))
    del gen, prompts
    torch.cuda.empty_cache()

    ops["decode_attention_int8"].launches = 0
    ops["decode_attention_int8_multirow"].launches = 0
    int8_err = phase_int8_kernel_vs_twin("cuda")
    int8_checks = {name: ops[name].launches for name in int8_err}
    int8_ms = phase_int8_kernel_timing()

    lean_err = phase_lean_kernel_vs_twin("cuda")
    lean_ms = phase_lean_kernel_timing()
    probe, counts = _main_path(phase_probe_main_path, "cuda")
    on_path = {k: n + counts[k] for k, n in on_path.items()}
    probe_err = phase_probe_vs_twin(probe)
    print(f"[{card}] probe at B={BATCH}, S=256, 6 layers: "
          + ", ".join(f"{n} {r['ms_per_layer']:.4f} ms per layer-read "
                      f"(floor {r['floor_ms']:.4f})" for n, r in probe.items())
          + f"; lean_attention lean8 {lean_ms['lean8']['ms']:.4f} ms/call, "
          f"lean4 {lean_ms['lean4']['ms']:.4f}")
    del probe
    torch.cuda.empty_cache()

    fp32_err = phase_fp32_kernel_vs_twin("cuda")
    fp32_ms = phase_fp32_kernel_timing()
    phase_fp32_models("cuda")
    phase_fp32_generator("cuda")
    torch.cuda.empty_cache()
    phase_serve_model("cuda")
    torch.cuda.empty_cache()
    (serve_tok_s, latency, _, _), counts = _main_path(phase_serve_main_path,
                                                      "cuda")
    if not counts["gqa_decode_update"]:
        raise AssertionError("the serving path launched no K1")
    serve_launches = counts["gqa_decode_update"]
    on_path = {k: n + counts[k] for k, n in on_path.items()}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ws = _cli_workspace(tmp)
        phase_http(ws, "cuda")
        cli, counts = _main_path(phase_sample_cli, ws, "cuda")
        on_path = {k: n + counts[k] for k, n in on_path.items()}
        # the training path (phases 21-23) runs none of K1-K7; its
        # dropout runs the dropout kernel
        from ai_music_generation_tpu_torch.ops.dropout import dropout_apply

        step_errs, train_launches = _main_path(phase_train_step, ws, "cuda")
        drop_ms = phase_dropout_kernel()
        dropout_apply.launches = 0
        music, counts = _main_path(phase_train_cli, ws, "cuda")
        train_launches = {k: n + counts[k] for k, n in train_launches.items()}
        gpt2, counts = _main_path(phase_train_bench)
        train_launches = {k: n + counts[k] for k, n in train_launches.items()}
        if any(train_launches.values()):
            raise AssertionError(f"the training path launched kernels of "
                                 f"the port: {train_launches}")
        if not dropout_apply.launches:
            raise AssertionError("the music training path launched no "
                                 "dropout kernel")
        drop_entry = _entry("dropout_apply", DROPOUT_SOURCE, None,
                            dropout_apply.launches, 0.0, drop_ms)
        kernels.append(drop_entry)
        trained_s, counts = _main_path(phase_sample_trained, ws,
                                       music["out_dir"], "cuda")
    on_path = {k: n + counts[k] for k, n in on_path.items()}
    print(f"[{card}] training: launches of K1-K7 {train_launches}; music "
          f"config {music['ms']:.2f} ms/iter, MFU {music['mfu']:.2f}%; "
          f"GPT-2 124M {gpt2['plain']['ms']:.2f} ms/iter, MFU "
          f"{gpt2['plain']['mfu'] * 100:.2f}%, peak "
          f"{gpt2['plain']['peak_bytes'] / 2**30:.2f} GiB; with remat "
          f"{gpt2['remat']['ms']:.2f} ms/iter, MFU "
          f"{gpt2['remat']['mfu'] * 100:.2f}%, peak "
          f"{gpt2['remat']['peak_bytes'] / 2**30:.2f} GiB; with "
          f"--attn_impl=flash (SDPA) {gpt2['flash']['ms']:.2f} ms/iter, "
          f"peak {gpt2['flash']['peak_bytes'] / 2**30:.2f} GiB; train step card "
          f"vs CPU {step_errs}; sampling the trained model "
          f"{trained_s:.2f} samples/s")
    print(f"[{card}] serving {serve_tok_s:.1f} tok/s at {SERVE_SLOTS} slots "
          f"(p50 {latency['p50_s']} s, p95 {latency['p95_s']} s, p99 "
          f"{latency['p99_s']} s); sample CLI {cli['bf16'][2]:.2f} samples/s"
          f" ({CLI_SAMPLES} x {CLI_NEW} tokens, bf16), fp32 "
          f"{cli['fp32'][2]:.2f}; fp32 K1 {fp32_ms['k1_fp32']['ms']:.4f} "
          f"ms/call, K1 ring at B={SERVE_SLOTS} "
          f"{fp32_ms['k1_ring']['ms']:.4f}, fp32 K2 verify "
          f"{fp32_ms['k2_fp32']['ms']:.4f}, refresh "
          f"{fp32_ms['k2_fp32_refresh']['ms']:.4f}, at the CLI's B="
          f"{CLI_SPEC_SAMPLES} {fp32_ms['k2_fp32_cli']['ms']:.4f}; fp32 K3 "
          f"{fp32_ms['k3_fp32']['ms']:.4f} (int8 cache), "
          f"{fp32_ms['k3_fp32_cache']['ms']:.4f} (fp32 cache; fp32 SDPA "
          f"{fp32_ms['k3_fp32_cache']['library_ms']:.4f})")
    # the TunesFormer paths (phases 24-28): K1 at their shapes, the model,
    # the generator, the server (+ HTTP) and the CLIs; each main path
    # launches K1 only
    tunes_err, tunes_checked = phase_tunes_kernel_vs_twin("cuda")
    tunes_ms = phase_tunes_kernel_timing()
    phase_tunes_model("cuda")
    torch.cuda.empty_cache()
    tunes_launches, tunes_calls = {}, {}

    def tunes_path(path, phase, *args):
        with _K1Calls() as calls:
            result, tunes_launches[path] = _main_path(phase, *args)
        tunes_calls[path] = calls
        return result

    gen_rate, big_rate, _, gen_bars, gen_peak = tunes_path(
        "generator", phase_tunes_generator, "cuda")
    torch.cuda.empty_cache()
    srv_rate, tunes_latency, _, _, srv_peak = tunes_path(
        "server", phase_tunes_server, "cuda")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ws = _tunes_workspace(tmp, "cuda")
        with _K1Calls() as http_calls:  # its shapes; its launches untold
            phase_tunes_http(ws, "cuda")
        tunes_path("cli", phase_tunes_cli, ws, "cuda")
    # TunesFormer training (phases 29-31): none of K1-K7 while it trains,
    # and the dropout kernel wherever it drops (phases 29 and 30, dropout
    # 0.1; phase 31 trains at dropout 0); sampling the trained weights.pth
    # runs K1 (a tunes path)
    tt_drops = {}
    dropout_apply.launches = 0
    tunes_step_errs, tt_launches = _main_path(phase_tunes_train_step,
                                                 "cuda")
    tt_drops["train_step"], dropout_apply.launches = (
        dropout_apply.launches, 0)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trained, counts = _main_path(phase_tunes_train_cli, tmp, "cuda")
        tt_launches = {k: n + counts[k] for k, n in tt_launches.items()}
        tt_drops["train_cli"], dropout_apply.launches = (
            dropout_apply.launches, 0)
        torch.cuda.empty_cache()
        tunes_path("trained", phase_tunes_sample_trained, trained, "cuda")
    torch.cuda.empty_cache()
    dropout_apply.launches = 0
    tunes_mfu, counts = _main_path(phase_tunes_mfu)
    tt_drops["tunes_mfu"] = dropout_apply.launches
    tt_launches = {k: n + counts[k] for k, n in tt_launches.items()}
    if any(tt_launches.values()):
        raise AssertionError(f"the TunesFormer training path launched "
                             f"kernels of the port: {tt_launches}")
    if not (tt_drops["train_step"] and tt_drops["train_cli"]) or tt_drops[
            "tunes_mfu"]:
        raise AssertionError(f"the TunesFormer training path's dropout "
                             f"launches {tt_drops}: phases 29-30 drop, 31 "
                             f"does not")
    drop_entry["tunes_launches"] = tt_drops
    print(f"[{card}] TunesFormer training: launches of K1-K7 "
          f"{tt_launches}, of the dropout kernel {tt_drops}; "
          f"cli/tunesformer_train.py at the reference "
          f"config (batch 8, bf16, dropout 0.1) {trained['ms']:.2f} ms/iter "
          f"(median of the steady epochs), peak {trained['peak_gib']:.2f} "
          f"GiB, eval loss {[round(v, 4) for v in trained['evals']]}; "
          + "; ".join(f"tunes_mfu B={r['batch']}: {r['ms_per_iter']:.2f} "
                      f"ms/iter, {r['tflop_per_step']:.3f} TFLOP/step "
                      f"(FlopCounterMode), MFU {r['mfu'] * 100:.2f}%, peak "
                      f"{r['peak_gib']:.2f} GiB" for r in tunes_mfu)
          + f"; train step card vs CPU {tunes_step_errs}")
    for path, c in tunes_launches.items():
        if any(n for k, n in c.items() if k != "gqa_decode_update"):
            raise AssertionError(f"the tunes {path} path launched another "
                                 f"kernel than K1: {c}")
        if sum(tunes_calls[path].launches.values()) != c["gqa_decode_update"]:
            raise AssertionError(f"the tunes {path} path's K1 launches by "
                                 f"mode {tunes_calls[path].launches} do not "
                                 f"add up to {c['gqa_decode_update']}")
        on_path = {k: n + c[k] for k, n in on_path.items()}
    seen = set().union(http_calls.shapes,
                       *(c.shapes for c in tunes_calls.values()))
    if not seen <= tunes_checked:
        raise AssertionError(f"the tunes paths ran K1 at (B, S, ring) "
                             f"{sorted(seen - tunes_checked)}, which phase 24 "
                             f"did not hold against the twin")
    print(f"K1 on the tunes paths at (B, S, ring) {sorted(seen)}, each held "
          f"against the twin in phase 24; launches by mode "
          f"{ {p: dict(c.launches) for p, c in tunes_calls.items()} }")
    print(f"[{card}] TunesFormer: generator {gen_rate:.1f} tunes/min at "
          f"B={TUNES_GEN_B} ({TUNES_MAX_PATCH} patches), {big_rate:.1f} at "
          f"B={TUNES_GEN_BIG} (peak {gen_peak:.2f} GiB); server "
          f"{srv_rate:.1f} tunes/min at {TUNES_SLOTS} slots (p50 "
          f"{tunes_latency['p50_s']} s, p95 {tunes_latency['p95_s']} s, p99 "
          f"{tunes_latency['p99_s']} s, peak {srv_peak:.2f} GiB); K1 at the "
          f"char step {tunes_ms['tunes_char']['ms']:.4f} ms (bound "
          f"{tunes_ms['tunes_char']['bound_ms']:.4f}, SDPA "
          f"{tunes_ms['tunes_char']['library_ms']:.4f}), at the lockstep "
          f"patch step {tunes_ms['tunes_patch']['ms']:.4f} ms (bound "
          f"{tunes_ms['tunes_patch']['bound_ms']:.4f}, SDPA "
          f"{tunes_ms['tunes_patch']['library_ms']:.4f}), at the ring patch "
          f"step {tunes_ms['tunes_ring']['ms']:.4f} ms (bound "
          f"{tunes_ms['tunes_ring']['bound_ms']:.4f}, SDPA "
          f"{tunes_ms['tunes_ring']['library_ms']:.4f})")
    # K1's ring mode (the serving tick, phase 19) and fp32 mode (phase 20's
    # --dtype=float32 run), K2's fp32 mode (phase 20's fp32 --speculative
    # run; its refresh and its verify at that run's B=64 beside): their own
    # launches and numbers
    kernels[0]["ring"] = dict(fp32_ms["k1_ring"], launches=serve_launches,
                              source=KERNEL_RING_SOURCE)
    kernels[0]["fp32"] = dict(fp32_ms["k1_fp32"], launches=cli["fp32"][0],
                              max_abs_err=max(
                                  fp32_err["gqa_decode_update"],
                                  fp32_ms["k1_fp32"]["max_abs_err"]))
    kernels[1]["fp32"] = dict(fp32_ms["k2_fp32"],
                              launches=cli["speculative fp32"][1],
                              max_abs_err=max(
                                  fp32_err["spec_attention_update"],
                                  fp32_ms["k2_fp32"]["max_abs_err"],
                                  fp32_ms["k2_fp32_refresh"]["max_abs_err"],
                                  fp32_ms["k2_fp32_cli"]["max_abs_err"]),
                              source=SPEC_F32_SOURCE,
                              refresh=fp32_ms["k2_fp32_refresh"],
                              cli=fp32_ms["k2_fp32_cli"])
    # K3, K5 and K6 have no caller on any path: their launches are the sum
    # of their counts over the main paths so far (phases 5-30; the MoE
    # paths below are asserted to launch K1 alone)
    kernels.append(_entry("spec_attention", SPEC_SOURCE,
                          SPEC_REPLACES["spec_attention"],
                          on_path["spec_attention"],
                          spec_err["spec_attention"],
                          spec_ms["spec_attention"], check_launches=k3_checks))
    # K3's fp32 mode over the int8 cache (no one PyTorch call computes it)
    # and over an fp32 cache, beside fp32 scaled_dot_product_attention
    kernels[-1]["fp32"] = dict(fp32_ms["k3_fp32"], source=SPEC_F32_SOURCE,
                               fp32_cache=fp32_ms["k3_fp32_cache"])
    for name in int8_err:
        kernels.append(_entry(name, PREFIX_SOURCE, PREFIX_REPLACES[name],
                              on_path[name], int8_err[name], int8_ms[name],
                              check_launches=int8_checks[name]))
    # K7's numbers are lean4's (the probe's position-packed int4 cache);
    # each mode's own are under "modes"
    kernels.append(_entry(
        "lean_attention", LEAN_SOURCE, LEAN_REPLACES,
        on_path["lean_attention"], max(*lean_err.values(), probe_err),
        lean_ms["lean4"], modes={name: dict(lean_ms[name],
                                            max_abs_err=lean_err[name])
                                 for name in LEAN_MODES}))
    # K1 at the TunesFormer shapes, an entry a mode: the char steps
    # (lockstep S = 32), the generators' patch steps (lockstep S = 128) and
    # the server's patch step (ring S = 128), each with its launches on the
    # generator, server and CLI paths (phases 26-28) and the batches it ran
    # at; library_ms is SDPA's attention alone (no column write)
    for name in ("tunes_char", "tunes_patch", "tunes_ring"):
        numbers = dict(tunes_ms[name])
        err = max(numbers.pop("max_abs_err"), tunes_err)
        kernels.append(_entry(
            f"gqa_decode_update/{name}",
            KERNEL_MHA_RING_SOURCE if name == "tunes_ring"
            else KERNEL_MHA_SOURCE, KERNEL_REPLACES,
            sum(c.launches[name] for c in tunes_calls.values()), err,
            numbers, batches=sorted({b for c in tunes_calls.values()
                                     for b, S, ring in c.shapes
                                     if _k1_mode(S, ring) == name})))
    # ABC -> WAV (phases 32-33): the synth and the eval pipeline launch
    # none of K1-K7
    synth, synth_launches = _main_path(phase_synth_vs_twin, "cuda")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        abc_wav, counts = _main_path(phase_abc_to_wav, tmp, "cuda")
        synth_launches = {k: n + counts[k] for k, n in synth_launches.items()}
        if any(synth_launches.values()):
            raise AssertionError(f"the ABC->WAV path launched kernels of "
                                 f"the port: {synth_launches}")
        torch.cuda.empty_cache()
        # the Audiobox scorer (phases 34-35) on phase 33's WAVs: no kernel
        # of the port
        aes, aes_launches = _main_path(phase_audiobox_model, tmp, "cuda")
        torch.cuda.empty_cache()
        aes_cli, counts = _main_path(phase_audio_aes_cli, tmp, aes["ckpt"],
                                     "cuda")
        aes_launches = {k: n + counts[k] for k, n in aes_launches.items()}
        if any(aes_launches.values()):
            raise AssertionError(f"the Audiobox path launched kernels of "
                                 f"the port: {aes_launches}")
    torch.cuda.empty_cache()
    print(f"[{card}] ABC->WAV: launches of K1-K7 {synth_launches}; synth "
          f"card vs CPU {synth} of the range; "
          f"cli/abc_to_midi_wav_and_aesthetics.py "
          f"{abc_wav['tunes_per_min']:.1f} tunes/min over {SYNTH_TUNES} "
          f"tunes (render {abc_wav['device_render']:.2f} s of "
          f"{abc_wav['wall']:.1f}); the render alone "
          + ", ".join(f"{r['tunes_per_min']:.1f} tunes/min at synth_batch "
                      f"{b} (peak {r['peak_gib']:.2f} GiB)"
                      for b, r in abc_wav["render"].items()))
    print(f"[{card}] Audiobox: launches of K1-K7 {aes_launches}; WavLM base "
          f"card vs CPU {aes['errs']} of the range (default TF32 flags "
          f"{aes['tf32_errs']}); "
          + ", ".join(f"forward {t['chunks_per_s']:.1f} 10-s chunks/s at "
                      f"batch {b} ({t['share']:.3f} of the FLOP bound, peak "
                      f"{t['peak_gib']:.2f} GiB)"
                      for b, t in aes["timing"].items())
          + f"; cli/audio_aes.py {aes_cli['files_per_min']:.1f} files/min, "
          f"{aes_cli['chunks_per_s']:.1f} chunks/s over {SYNTH_TUNES} WAVs")
    # MoE (phases 36-40): K1 at the MoE paths' shapes; the model card vs
    # CPU; the train CLI and a resume (no kernel); decode of the trained
    # model and of the bench config with 4 experts; serving; the sampling
    # CLI. Each decode path launches K1 only, at shapes phase 36 checked
    moe_err, moe_checked = phase_moe_kernel_vs_twin("cuda")
    moe_k1 = phase_moe_kernel_timing()
    moe_model = phase_moe_model("cuda")
    torch.cuda.empty_cache()
    moe_counts = {}
    with _K1Calls() as moe_calls:
        with tempfile.TemporaryDirectory() as tmp:
            moe_train, moe_counts["train"] = _main_path(phase_moe_train, tmp,
                                                        "cuda")
            torch.cuda.empty_cache()
            moe_dec, moe_counts["decode"] = _main_path(
                phase_moe_decode, moe_train, "cuda")
            moe_cli, moe_counts["sample_cli"] = _main_path(
                phase_moe_sample_cli, moe_train, "cuda")
        torch.cuda.empty_cache()
        moe_bench, moe_counts["bench"] = _main_path(phase_moe_bench_decode,
                                                    "cuda")
        torch.cuda.empty_cache()
        moe_srv, moe_counts["serve"] = _main_path(phase_moe_serve, "cuda")
        torch.cuda.empty_cache()
    if any(moe_counts["train"].values()):
        raise AssertionError(f"MoE training launched kernels of the port: "
                             f"{moe_counts['train']}")
    for path, c in moe_counts.items():
        if any(n for k, n in c.items() if k != "gqa_decode_update"):
            raise AssertionError(f"the MoE {path} path launched another "
                                 f"kernel than K1: {c}")
    if not moe_calls.keys <= moe_checked:
        raise AssertionError(f"the MoE paths ran K1 at "
                             f"{sorted(moe_calls.keys - moe_checked)}, "
                             f"which phase 36 did not hold against the twin")
    moe_k1_launches = {p: c["gqa_decode_update"]
                       for p, c in moe_counts.items() if p != "train"}
    # the entry's kernel is G = 1's: the trained MHA model's paths; the
    # bench config (KH=2) and its server run gqa_decode.cu's and
    # gqa_decode_ring.cu's, and stand in by_path
    kernels.append(_entry(
        "gqa_decode_update/moe", KERNEL_MHA_SOURCE, KERNEL_REPLACES,
        sum(n for p, n in moe_k1_launches.items()
            if p not in ("bench", "serve")),
        max(moe_err, moe_k1.pop("max_abs_err")), moe_k1,
        ring_launches=moe_k1_launches["serve"], by_path=moe_k1_launches,
        shapes=sorted(f"B={b} S={S} KHD={khd} {str(dt)[6:]} "
                      f"{'ring' if ring else 'lockstep'}"
                      for b, S, khd, dt, ring in moe_calls.keys)))
    steps = moe_train["steps"]
    print(f"[{card}] MoE (4 experts, top 2): model card vs CPU "
          f"{ {k: v for k, v in moe_model.items()} }; train CLI "
          f"{moe_train['ms']:.2f} ms/iter (MFU {moe_train['mfu']:.2f}%, "
          f"inflated), val loss {[round(v, 4) for v in moe_train['val']]}; "
          f"train step dense {steps['dense']['ms']:.2f} ms vs MoE "
          f"{steps['moe']['ms']:.2f} ms = {moe_train['ratio']:.3f} (FLOP "
          f"ratio {moe_train['flop_ratio']:.3f}), peak "
          f"{steps['dense']['peak_gib']:.3f} / {steps['moe']['peak_gib']:.3f}"
          f" GiB; decode (trained, B={MOE_DECODE_B}) {moe_dec['tok_s']:.1f} "
          f"tok/s, peak {moe_dec['peak_gib']:.2f} GiB; bench config "
          f"(B={BATCH}, window {WINDOW}) {moe_bench['tok_s']:.1f} tok/s, "
          f"peak {moe_bench['peak_gib']:.2f} GiB; serving "
          f"{moe_srv['tok_s']:.1f} tok/s at {SERVE_SLOTS} slots (p50 "
          f"{moe_srv['latency']['p50_s']} "
          f"s, p95 {moe_srv['latency']['p95_s']} s, p99 "
          f"{moe_srv['latency']['p99_s']} s, peak {moe_srv['peak_gib']:.2f} "
          f"GiB); sample CLI {moe_cli['samples_s']:.2f} samples/s; K1 "
          f"launches {moe_k1_launches}; K1 at the decode step "
          f"{moe_k1['ms']:.4f} ms (bound {moe_k1['bound_ms']:.4f}, SDPA "
          f"{moe_k1['library_ms']:.4f})")
    # the sharded trainer (phase 41): no kernel of the port
    mesh, mesh_launches = _main_path(phase_mesh_train, "cuda")
    if any(mesh_launches.values()):
        raise AssertionError(f"the sharded trainer launched kernels of the "
                             f"port: {mesh_launches}")
    print(f"[{card}] mesh training: launches of K1-K7 {mesh_launches}; "
          f"{mesh['backend']} at world size {mesh['world']}; ms/iter plain "
          f"{mesh['plain_ms']:.3f} vs sharded {mesh['mesh_ms']:.3f} (MoE "
          f"{mesh['plain_moe_ms']:.3f} vs {mesh['mesh_moe_ms']:.3f}); loss "
          f"errors {mesh['errs']}")
    # the sharded servers, render and the pipeline and sequence steps
    # (phase 42), in a group of one over NCCL: the serving path launches
    # K1 alone, the render and the steps none of K1-K7
    from ai_music_generation_tpu_torch.parallel.distributed import (
        group_of_one,
    )

    with group_of_one("cuda"):
        srv_mesh, counts = _main_path(phase_mesh_serve)
        if any(n for k, n in counts.items() if k != "gqa_decode_update"):
            raise AssertionError(f"the sharded serving path launched another "
                                 f"kernel than K1: {counts}")
        tunes_mesh, counts = _main_path(phase_mesh_tunes)
        if any(n for k, n in counts.items() if k != "gqa_decode_update"):
            raise AssertionError(f"the sharded tunes path launched another "
                                 f"kernel than K1: {counts}")
        _, synth_counts = _main_path(phase_mesh_synth)
        steps, counts = _main_path(phase_mesh_steps)
        if any(synth_counts.values()) or any(counts.values()):
            raise AssertionError(f"the sharded render or the pipeline and "
                                 f"sequence steps launched kernels of the "
                                 f"port: {synth_counts}, {counts}")
    kernels[0]["by_path"] = {"serve_mesh": srv_mesh["launches"]}
    print(f"[{card}] sharded serving (world size 1): "
          f"{srv_mesh['mesh_tok_s']:.1f} tok/s vs unsharded "
          f"{srv_mesh['plain_tok_s']:.1f}, K1 launches "
          f"{srv_mesh['launches']}; TunesServer {tunes_mesh['mesh']:.1f} "
          f"tunes/min vs {tunes_mesh['plain']:.1f}; render bit-equal; "
          f"pipeline and sequence steps: launches of K1-K7 {counts}, loss "
          f"errors {steps['errs']}, ms/step plain {steps['plain_ms']:.3f}, "
          f"pipeline {steps['pipe_ms']:.3f}, sequence {steps['seq_ms']:.3f}")
    # GPT-2 import (phase 43): K1 at GPT-2 124M's decode step, the model
    # loaded from a HF-layout directory card vs CPU, sampling through K1
    # (every K1 shape of the path checked and timed here), evaluation and a
    # fine-tune (no kernel of the port), the sizing report
    gpt2_t0 = time.perf_counter()
    gpt2_k1, gpt2_checked = phase_gpt2_kernel()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        gpt2_ws = _gpt2_workspace(tmp)
        gpt2_model = phase_gpt2_model(gpt2_ws)
        gpt2_model_err = gpt2_model["err"]
        with _K1Calls() as gpt2_calls:
            (gen, prompts, gpt2_launches), counts = _main_path(
                phase_gpt2_main_path, gpt2_ws)
        if any(n for k, n in counts.items() if k != "gqa_decode_update") \
                or counts["gqa_decode_update"] != 2 * gpt2_launches:
            raise AssertionError(f"the GPT-2 sampling path launched {counts}")
        if not gpt2_calls.keys <= gpt2_checked:
            raise AssertionError(f"the GPT-2 path ran K1 at "
                                 f"{sorted(gpt2_calls.keys - gpt2_checked)}, "
                                 f"which phase 43 did not check and time")
        gpt2_tok_s = phase_throughput(gen, prompts, runs=1)
        gpt2_peak = torch.cuda.max_memory_allocated() / 2**30
        del gen, prompts
        torch.cuda.empty_cache()
        gpt2_train, counts = _main_path(phase_gpt2_train, gpt2_ws,
                                        gpt2_model["cpu"])
        if any(counts.values()):
            raise AssertionError(f"GPT-2 training launched kernels of the "
                                 f"port: {counts}")
    del gpt2_model
    torch.cuda.empty_cache()
    gpt2_peak_flops = phase_gpt2_sizing()
    gpt2_s = time.perf_counter() - gpt2_t0
    # the replay harness (phase 44) on the card: no kernel of the port
    replay_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        replay, counts = _main_path(phase_replay, tmp)
    replay_s = time.perf_counter() - replay_t0
    if any(counts.values()):
        raise AssertionError(f"the replay harness launched kernels of the "
                             f"port: {counts}")
    torch.cuda.empty_cache()
    kernels[0]["by_path"]["gpt2"] = gpt2_launches
    kernels.append(_entry(
        "gqa_decode_update/gpt2", KERNEL_MHA_SOURCE, KERNEL_REPLACES,
        gpt2_launches, gpt2_k1.pop("max_abs_err"), gpt2_k1,
        shapes=sorted(f"B={b} S={S} KHD={khd} {str(dt)[6:]} "
                      f"{'ring' if ring else 'lockstep'}"
                      for b, S, khd, dt, ring in gpt2_calls.keys)))
    print(f"[{card}] GPT-2 124M (random init from a HF-layout directory): "
          f"model card vs CPU {gpt2_model_err:.3e} of the range; sampling "
          f"{gpt2_tok_s:.1f} tok/s at B={GPT2_B} ({GPT2_NEW} new tokens, "
          f"peak {gpt2_peak:.2f} GiB), {gpt2_launches} K1 launches a "
          f"generate; K1 at the decode step {gpt2_k1['ms']:.4f} ms (bound "
          f"{gpt2_k1['bound_ms']:.4f}, SDPA {gpt2_k1['library_ms']:.4f}); "
          f"eval loss {gpt2_train['eval']['val/loss']:.4f}; fine-tune "
          f"losses {[v for _, v in gpt2_train['losses']]} (iter 0 vs CPU "
          f"fp32 {gpt2_train['cpu_loss']:.6f}); sizing at "
          f"{gpt2_peak_flops / 1e12:.0f} TFLOP/s; phase 43 {gpt2_s:.1f} s; "
          f"phase 44 {replay_s:.1f} s (the harness {replay['wall']:.1f} s, "
          f"fixtures {replay['fixtures_s']:.1f} s): {replay['rows']}")
    # the last host entry points (phase 45): the transfer experiment (its
    # iterations cut) trains on the card, then each host CLI runs once; no
    # kernel of the port
    host_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        transfer, counts = _main_path(phase_transfer, tmp)
        clis, cli_counts = _main_path(phase_host_clis, tmp)
    host_s = time.perf_counter() - host_t0
    if any(counts.values()) or any(cli_counts.values()):
        raise AssertionError(f"the transfer experiment or the host CLIs "
                             f"launched kernels of the port: {counts}, "
                             f"{cli_counts}")
    torch.cuda.empty_cache()
    print(f"[{card}] transfer experiment (TRANSFER_ITERS, bf16): best val "
          f"loss "
          f"melody {transfer['best']['melody']:.4f}, transfer "
          f"{transfer['best']['transfer']:.4f}, scratch "
          f"{transfer['best']['scratch']:.4f}: transfer "
          f"{transfer['verdict']} scratch; ms/iter melody "
          f"{transfer['ms']['melody']:.2f}, transfer "
          f"{transfer['ms']['transfer']:.2f}, scratch "
          f"{transfer['ms']['scratch']:.2f}; the experiment "
          f"{transfer['wall']:.1f} s; launches of K1-K7 {counts}; host CLIs "
          f"{clis['wall']:.1f} s {clis['counts']}; phase 45 {host_s:.1f} s")
    # the trained-model decode studies (phase 46): K1 on every plain
    # generate, CLI run and soak tick, K2 (bf16 verify, int8_dots) on the
    # speculative ones; none of K3-K7; then worker_smoke over NCCL
    studies_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        studies, counts = _main_path(phase_studies, tmp)
        studies_s = time.perf_counter() - studies_t0
        k1_k2 = ("gqa_decode_update", "spec_attention_update")
        if any(n for k, n in counts.items() if k not in k1_k2) or not all(
                counts[k] for k in k1_k2):
            raise AssertionError(f"the studies launched {counts}")
        dots = phase_int8_dots_timing()
        torch.cuda.empty_cache()
        # the last experiment scripts (phase 47), in phase 46's work
        # directory: K1 on every generate, no other kernel
        exp_t0 = time.perf_counter()
        experiments, exp_counts = _main_path(phase_experiments, tmp)
        experiments_s = time.perf_counter() - exp_t0
    if any(n for k, n in exp_counts.items() if k != "gqa_decode_update") \
            or not exp_counts["gqa_decode_update"]:
        raise AssertionError(f"the experiments launched {exp_counts}")
    res = studies["results"]
    trace = res["spec_trace"]
    kernels[0]["by_path"]["studies"] = counts["gqa_decode_update"]
    kernels[1]["by_path"] = {"studies": counts["spec_attention_update"]}
    kernels[1]["int8_dots"] = dict(
        dots, name="spec_attention_update/int8_dots",
        replaces=SPEC_REPLACES["spec_attention_update"],
        redesign="mma.sync m16n8k32 s8 for both products (before: __dp4a "
                 "on the CUDA cores)",
        launches=trace["int8dots_k7"]["counts"]["k2"],
        ms_per_step=trace["int8dots_k7"]["ms_per_step"])
    rb, soak = res["realpath_bench_r5"], res["serve_soak"]
    print(f"[{card}] trained-model studies ({STUDY_ITERS} iterations a "
          f"checkpoint): flagship val loss {rb['train']['val_loss']:.4f}; "
          f"sample CLI {rb['cli'][0]['warm']['samples_s']:.2f} samples/s "
          f"(window {BENCH['block_size']}), "
          f"{res['realpath_window_r5']['cli'][0]['warm']['samples_s']:.2f} "
          f"(window 128); teacher NLL window 256/128 "
          f"{rb['window']['teacher_nll']}, window 64 "
          f"{res['window64_probe']['quality']['teacher_nll']}; int8 vs bf16 "
          f"{res['int8_quality']['teacher_nll']}; spec committed/step "
          + ", ".join(f"n_draft {k} {t['committed_per_step'][0]:.3f} "
                      f"({t['speedup']:.3f}x plain)"
                      for k, t in res["spec_decode"]["spec"].items())
          + f"; spec_trace ms/step plain {trace['plain']['ms_per_step']:.3f},"
          f" bf16 {trace['bf16_k7']['ms_per_step']:.3f}, int8_dots "
          f"{trace['int8dots_k7']['ms_per_step']:.3f}; K2 int8_dots "
          f"{dots['ms']:.4f} ms/call (bound {dots['bound_ms']:.4f}; fp32 q "
          f"{dots['fp32']['ms']:.4f}; bf16-dot {dots['bf16_dot_ms']:.4f}; "
          f"{INT8_DOTS_MID} live columns {dots['mid']['ms']:.4f}, bf16-dot "
          f"{dots['mid']['bf16_dot_ms']:.4f}); soak "
          f"spread {soak['warm_spread']:.4f}, rss "
          f"{soak['rss_growth_mb']:+.1f} MB, device "
          f"{soak['device_growth_mb']:+.1f} MB; launches {counts}; phase 46 "
          f"{studies_s:.1f} s")
    kernels[0]["by_path"]["experiments"] = exp_counts["gqa_decode_update"]
    print(f"[{card}] " + _experiments_summary(experiments["results"])
          + f"; launches {exp_counts}; phase 47 {experiments_s:.1f} s")
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
