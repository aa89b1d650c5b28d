#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aiko_services_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device and build: the card's name and power limit (nvidia-smi), and
     the seconds nvcc took to build every kernel from csrc/ (every nvcc
     starts at once; the head-dim-128 libraries finish while the phases
     before llama_8b run, and their line comes before llama_8b);
  1b. native: the port's host C++ extension (native/aiko_native.cpp,
     built with g++ into aiko_services_tpu_torch/_build/ at first use)
     loads, and agrees with its plain versions with no mismatch on a
     seeded corpus of NATIVE_TOPICS registrar-shaped topic pairs and
     NATIVE_PAYLOADS nested payloads (native.parity_corpus); host
     microseconds a call both ways, on the machine that has the card.
     The remote_pipeline, peer_pipeline and peer_chaos phases route
     every topic through the native matcher (a count around
     message._impl_topic_matches, each above 0);
  2. kernels: each kernel against its plain PyTorch version at the shapes
     its path gives it, in bf16, with its stated tolerance (flash at the
     slice phase's batch of 8 and the pipeline's batch of 32, and at a
     TP-2 rank's 6 of Whisper-small's 12 heads at that batch, the
     flash_attention_tp2 row, which no phase of one card launches);
     median
     device times (time_ms: the host runs ahead of the card, so the
     events bracket device work alone; the timer line shows a call that
     launches nothing at ~0) of the kernel, the plain version and one
     PyTorch library call
     computing the same function (timed only: the port never calls it),
     and the least time the card could take (bound_ms); cross-decode at
     the decode tail's T = 1536 (bucket 3072) and T = 250 (bucket 500);
     the paged kernel
     at the Llama decode shape, t_cap 256 and 512, natively and with int8
     pools (scales folded), and at the chunked-prefill extend shape (16
     rows of a 64-token chunk, 256 query rows per KV head, offsets drawn
     from [0, 512]) with int8 pools dequantized and natively, and at the
     agent's extend (8 rows of a 128-token chunk, 512 query rows per KV
     head, a 128-entry side buffer, offsets from [0, 1024]) natively;
  3. slice: Whisper-small at full width (768 / 12 heads / 12 + 12 layers /
     51,865 vocab), bf16, seeded random weights, served through
     ComputeRuntime + PE_WhisperASR (two elements of one port pipeline,
     fed with submit()): long requests (bucket 3072, audio context 1536,
     the flash kernel) and short ones (bucket 500, plain attention) on
     the int16 and mu-law wires; the launch counts of that run; one long
     request's encoder features with the kernel against the plain
     version;
  3b. surface: the models package's greedy_decode (the re-export of
     whisper.greedy_decode) on the card, Whisper-small at full width in
     bf16 with seeded weights, a batch of four 25-30 s inputs at bucket
     3072 (context 1536, the flash kernel), max_tokens 24, under a
     Tracer.span whose time goes into a Histogram (its quantiles
     printed beside the card's name and power limit): the flash launches
     the CPU rehearsal predicts (SURFACE_FLASH, 12 for one encode, at
     the flash_attention_b4 row's shape), and tokens and lengths equal
     to greedy_decode_scored's on the same mel;
  4. profile: one steady batch per bucket under torch.profiler (device
     busy time, idle share, launches, the costliest kernels);
  4b. pipeline: examples/speech/pipeline_transcription.json on the port's
     host plane (ProcessRuntime + ComputeRuntime + Pipeline on a virtual
     clock), Whisper-small in bf16 with only the gates opened: 8 short
     streams (1 s chunks, window 3, 4 frames: bucket 500) and 4 long
     ones (10 s chunks, 3 frames of 10 / 20 / 30 s: buckets 1000 and
     3072); every frame completes with tokens and text, PE_Speaker
     collects audio for every stream, the flash kernel launches 12 x the
     bucket-3072 batches, the scheduler coalesces streams (mean batch
     size > 1) and no timer outlives teardown; frames and batches per
     bucket, virtual and wall seconds, first-call and steady seconds;
  4c. remote_pipeline: examples/speech/pipeline_transcription_remote.json
     unedited: a caller runtime whose remote_asr hop crosses the binary
     wire (the i8mel codec the definition names, passed as
     remote_wire_codecs) to a serving pipeline p_transcription_server
     ((PE_WhisperASR (PE_Synthesize)), Whisper-small in bf16 with the
     local example's parameters, behind an AdmissionGate reading the
     scheduler's wait estimate) found through the port's Registrar, three
     runtimes on one broker and a virtual clock: 4 short streams and 2
     long ones, 22 frames; every frame completes with the server's
     tokens, the i8mel bytes that crossed are mel_i8_pack of the
     caller's mel, the wire and admission counters and the hop histogram
     count every frame, the wire made one device-to-host copy per frame,
     flash launches 12 x the bucket-3072 batches at the pipeline's shape,
     no hop is pending and no timer outlives teardown; envelopes and
     bytes each way, hop p50, virtual and wall seconds, the copies'
     seconds;
  4d. peer_pipeline: the same run with the caller's and the server's
     runtime on TCP peer channels (enable_peer(kinds=("tcp",)),
     127.0.0.1): every request and reply envelope of the hop crosses one
     socket and none rides the broker (spies on both topics see none),
     one handshake, the drive advancing the virtual clock only when no
     envelope is on the socket (peer.in_flight); the caller's tokens
     equal remote_pipeline's frame by frame; the channel's envelopes and
     bytes each way, the copies;
  4e. peer_chaos: the same traffic over the same channels under two
     seeded FaultPlans (PEER_CHAOS: the caller's channel drops a fifth
     of its requests, the server's delays half of its replies) with hop
     retries: every frame completes, faults and retries above 0, one
     device-to-host copy per frame sent, tokens equal peer_pipeline's;
  4f. cli: `python -m aiko_services_tpu_torch pipeline show` and
     `params` on both speech examples exit 0; ProcessManager.spawn_python
     starts `pipeline create examples/speech/pipeline_transcription.json
     --PE_MicrophoneSim.limit 3` on the card: the card's free memory
     falls by at least CLI_MIN_FALL_GB while it runs, it does not exit
     on its own, ProcessManager.delete stops it;
  5. llama: Llama-1B at full width (2048 / 32 heads / 8 KV heads / 16
     layers / 128,256 vocab), bf16, seeded random weights, served by the
     paged ContinuousDecoder (16 slots, 16 steps per sync, 32-token
     blocks, prefill bucket 128, max_seq 1024): 24 requests, 8 of them
     submitted after the first round and one long enough to take t_cap
     from 256 to 512; every request completes with its budget, the pool
     drains, the paged kernel launches once per layer per decode step;
     tokens/s, round seconds, and one steady round under torch.profiler;
  6. llama_f32: full width at 2 layers in f32: the paged decoder's greedy
     tokens against llama_greedy_decode (dense cache, plain attention);
  7. llama_int8_chunked: Llama-1B at full width, bf16, with int8 KV pools
     and chunked prefill (chunks of 64, bucket 64, 16 slots, 8 steps per
     sync, 32-token blocks, max_seq 1024): 24 requests of 32 new tokens,
     8 with 16-64 prompt tokens and 16 with 65-640 (the first exactly
     640, so t_cap reaches 768), 8 submitted after the first round; every
     request completes, the pool drains, the folded int8 kernel launches
     16 x decode steps and the dequantizing one 16 x extend dispatches,
     and no call synchronizes the stream beyond each round's one wait
     (torch's sync debug mode); tokens/s, rounds, chunk counts, and one
     round under torch.profiler;
  8. llama_int8_f32: full width at 2 layers in f32, the same decoder with
     4 slots: 4 requests of 40 / 100 / 200 / 300 prompt tokens against
     the same port decoder on the CPU (the kernels' plain versions);
  9. agent: a one-element pipeline (PE_LlamaAgent: Llama-1B at full
     width, bf16, continuous mode through the paged decoder with a
     prefix cache of 32-token blocks and the session table; 8 slots, 32
     new tokens a turn, prompt_length 128, 4 steps per sync), 8 streams
     x 3 turns on a virtual clock, each turn re-submitting the stream's
     history: every frame completes, the prefix cache admits turns 2-3,
     prefill + cached tokens = prompt tokens, the paged kernel launches
     exactly 16 x the predicted decode steps and extend dispatches
     (AGENT_*), the leases lapse to an empty table and no pinned block,
     and after purge the pool holds no block; one round of prefix-hit
     extends under torch.profiler;
  10. agent_f32: the same conversation at full width and 2 layers in f32:
     each turn against llama_greedy_decode on its whole history prompt;
  11. assistant: examples/speech/pipeline_assistant.json as written
     (PE_NeuralTTS at its base preset, Griffin-Lim) with the agent's
     preset, paged, prefix_block and sessions overridden: Whisper-small,
     Llama-1B and the TTS model on one ComputeRuntime, 4 streams x 3
     five-second chunks; every frame carries whole hops of finite TTS
     audio and PE_Speaker collects all of it.
  12. detect: examples/pipeline/pipeline_detect.json less its file source
     (the repo holds no video file), at its own parameters (detector_r18:
     a ResNet-18 backbone of width 64, 64-channel neck, 80 classes, K =
     32; 256 x 256, max_batch 32, pipelined, max_in_flight 4, f32, the
     raw uint8 wire): one warm-up batch, then 8 streams x 16 seeded frames
     with moving rectangles posted into (PE_Detect (PE_Tracker)); every
     frame completes with well-formed detections and tracks, the results
     worker holds 2-4 batches in flight, each batch crosses to the card as
     one uint8 copy; frames/s, steady batch service s, track ids per
     stream, peak memory, one batch under torch.profiler, and the detect
     program's device ms in f32 (TF32 off), f32 with TF32 and bf16;
  13. detect_dct8: the same drive on the dct8 wire (keep 16): 49,152
     bytes a frame cross to the card instead of 196,608;
  14. detect_f32: the same weights and frames (2 streams x 8) through the
     detect graph on the card and on the CPU: classes and track ids equal,
     scores and boxes within DETECT_SCORE_TOL / DETECT_BOX_TOL (a CPU
     score gap under DETECT_TIE at the first difference is a tie);
  15. classify: ResNet-18 at 224 x 224 (1000 classes, f32) through
     (PE_ImageClassify), batched, max_batch 32: 64 seeded frames; class
     ids equal the CPU port's on the same weights, confidences within
     CLASSIFY_TOL; frames/s, batch service s, peak memory.
  16. llama_dense: the llama phase's 24 requests through the dense slot
     cache (paged_kv False, the JAX default) at LLAMA_CUT_LAYERS (8) of
     Llama-1B's 16 layers (the depth cut that keeps the script in its
     time): every request completes, no paged launch; tokens/s, rounds,
     the cache's bytes, one round under torch.profiler, and where a
     request splits from the paged decoder at that depth, its top-2
     logit gap there;
  17. llama_spec: the same traffic and depth through the paged decoder
     with speculate_k 2, then 4 (speculate_ngram 2): the paged kernel
     launches 8 x the verify steps, at W = 3 and W = 5; the accept
     rate, tokens/s, rounds, one round under the profiler, the top-2
     gaps where requests split from the paged decoder without
     speculation;
  18. llama_spec_int8: the int8 chunked decoder and traffic with
     speculate_k 2 under torch's sync debug mode: every request
     completes, the folded kernel launches 16 x the verify steps and the
     dequantizing one 16 x the extend dispatches;
  19. decoder_f32: full width at 2 layers in f32: the dense decoder, the
     dense one with speculate_k 2 and the paged one with speculate_k 2
     and 4 against llama_greedy_decode, with a mid-stream admit and an
     EOS inside a verify block; the dense int8 decoder on the card
     against itself on the CPU;
  20. agent_dense: the agent phase's conversation through PE_LlamaAgent
     at paged false (the dense decoder, dense prefix nodes): every frame
     completes, turns 2-3 hit the cache, hits copy rows, no paged
     launch;
  21. tts: a one-element pipeline (PE_NeuralTTS at preset base: dim 128,
     4 layers, max_tokens 128, max_frames 1024, f32; batched, max_batch
     16, 32 Griffin-Lim rounds) on a ComputeRuntime, one warm-up batch,
     then 16 streams x 4 seeded texts of 8-128 bytes (one of 200: the
     truncation binds): every frame completes with finite audio of the
     element's voiced length (max(samples, 160) within the synthesized
     row), no attention kernel launches; frames/s, steady batch s, and
     one batch under torch.profiler (launches a batch, idle share);
     then the same drive with a seeded base vocoder checkpoint (flat
     npz written to a temporary directory) in place of Griffin-Lim;
  22. tts_f32: the tts phase's weights and 2 x 4 of its texts through
     the element on the card and on the CPU port, Griffin-Lim and the
     vocoder: totals within 1e-4 + 1e-6 x the total (f32 sums of 128
     durations in another order), equal voiced lengths (one frame off
     only at a tie), mel, STFT magnitudes and vocoder waveforms
     within TTS_*_REL_L2;
  23. media: PE_MicrophoneSim → PE_FFT → PE_AudioFilter →
     PE_AudioResampler and PE_MicrophoneSim → PE_FFT → PE_GraphXY: the
     FFT runs on the card and its magnitudes equal numpy's within 1e-5;
  24. llama_moe: 8x1b (Llama-1B's widths, 8 experts of 8192, top 2,
     ~10 GB of weights) in bf16 served by the llama phase's paged
     decoder on LLAMA_MOE_REQUESTS of its requests (its long one left
     out): every request completes, the pool drains, the paged kernel
     launches 16 x the predicted LLAMA_MOE_STEPS decode steps; tokens/s,
     rounds, dropped assignments a round, one round under the profiler;
     the model is freed after;
  25. llama_moe_f32: 8x1b at 2 layers in f32: the paged decoder with 16
     slots on the card against the same decoder on the CPU (a split
     passes only at a CPU top-2 logit gap or a router boundary gap under
     MOE_*_TIE), and with every expert chosen (no drops) against
     llama_greedy_decode.
  26. agent_tiered: the agent phase's conversation with a host KV tier
     (host_kv_mb 512) and a 64-block prefix cache, the 8 streams' turns
     in lockstep and every session demoted (PrefixKVCache.
     demote_sessions) between turns, under torch's sync debug mode: the
     demotions copy pool blocks to pinned host memory and the next turn
     prefetches (a worker thread on its own stream, handing back a CUDA
     event) and promotes them without any synchronizing call; every
     stream's chain demotes, prefill + cached = prompt tokens, the KV
     ledger conserves after every round with no violation, the paged
     kernel launches 16 x AGENT_TIERED_DECODE_STEPS and 16 x
     AGENT_TIERED_EXTEND_DISPATCHES, and after the leases lapse every
     chain promotes back and a purge leaves both tiers empty; one round
     of promotions and extends under torch.profiler;
  27. agent_tiered_f32: the same at 2 layers in f32: every turn against
     llama_greedy_decode on its whole history;
  28. llama_wq: the llama phase's traffic and decoder with weight_quant,
     then with fuse_projections, at LLAMA_CUT_LAYERS (8) of Llama-1B's
     16 layers since PR 25: tokens/s, parameter bytes (JAX's rule),
     peak memory, 8 x 326 paged launches each; both at 2 layers in f32
     on the card against the same decoder on the CPU;
  29. llama_select: the dense decoder in the select KV write
     (AIKO_DECODE_KV=select): the llama traffic at full width (8 of 16
     layers since PR 25) with the two_pass inner loop (tokens/s, no paged launch); at 2 layers in
     f32, two_pass, online and vpu each against llama_greedy_decode and
     the block write;
  30. decoder_chaos: ChaosDecoder around the prefix-cached paged
     Llama-1B decoder (bf16, prefill chunks of 128, LLAMA_CUT_LAYERS of
     its 16 layers since PR 25): a preemption, a
     pool-growth refusal and a hung scan, each drained with a deadline
     of 0, checkpointed and resumed from prompt + generated: every
     request completes with its budget, CHAOS_EVACUATED evacuations and
     CHAOS_CHECKPOINTS checkpoints, one flight record a fault, one
     journey a submission, a TTFT p50 per tenant, the predicted paged
     launches; at 2 layers in f32 the faulted run's streams against the
     same drive without faults.
  31. disagg: DisaggHarness (serving_disagg.py) on Llama-1B in bf16 with
     the JAX rung's geometry (DISAGG_HARNESS), colocated then
     disaggregated: the probe (200 tokens, 16 new) and measure() (6
     decode streams, bursts of 4 prompts of 288 tokens sharing a
     144-token prefix every 0.4 s in the window's second half) under
     torch's sync debug mode and a KV ledger audited every decode round:
     nothing lost, no local fallback, every installed block byte-equal
     to the shipped one, no synchronizing call, the probe's counts
     (DISAGG_PROBE_COUNTS); transfers, bytes, handle-hit rate and the
     streams' ITL p50 / p95 with and without the burst (reported, not
     gated: both decoders share one card and one host thread);
  32. disagg_variants: the probe disaggregated with int8 KV, with chunk
     streaming off, and into a cacheless paged pool (the direct
     install), each byte-checked and counted (DISAGG_VARIANT_COUNTS);
  33. disagg_f32: the probe at 2 layers in f32, colocated and
     disaggregated against llama_greedy_decode, int8 disaggregated
     against int8 colocated;
  34. agent_disagg: the agent's conversation with role "decode" and
     disagg true beside a PrefillRuntime found through the registrar:
     every first turn remote, prefill + cached = prompt tokens,
     role=decode in the pipeline's tags, AGENT_DISAGG_COUNTS;
  35. agent_migrate: two serving sides (decoder, prefix cache, session
     table, SessionMigrator; A with a 512 MB host tier), 8 sessions x 2
     turns on A, demoted, migrated to B, A purged to 0 blocks, both
     ledgers clean, turn 3 on B a prefix hit of every chain; at 2 layers
     in f32 turn 3 against llama_greedy_decode.
  35a. agent_migrate_mesh: the same drive with B's decoder and prefix
     cache on create_mesh({"model": 1}): B's SessionMigrator takes each
     offer, install and landing at its decoder's round note; every count
     of agent_migrate, turn 3's tokens equal agent_migrate's, no call
     synchronizes the stream while the sessions migrate (torch's sync
     debug mode), and at 2 layers in f32 every turn 3 identical to
     llama_greedy_decode.
  35b. ops: the operations plane around the paged decoder: Llama-1B in
     bf16 (the llama phase's decoder, its PhaseProfiler always on)
     serves OPS_REQUESTS seeded requests while a MetricsPublisher
     publishes its registry on a memory broker, a SeriesStore +
     HealthAggregator evaluates one SLORule on the serving_ttft_seconds
     sketch, an Autoscaler drives a LifeCycleManager of in-process
     clients on the TTFT signal, and a DevicePool holds the card; one
     arm_trace window (torch.profiler) covers a round or two.  The
     phases sum to the committed rounds' wall within 1% (rounds outside
     the window, timed around pump), attributed_fraction >= 0.9, the
     Chrome trace's paged kernel launches equal the wrapper's count in
     the window, every round outside the window runs under sync debug
     mode "error", the autoscaler's decisions and the alert states are
     OPS_DECISIONS / OPS_ALERTS (from the CPU rehearsal: they depend on
     virtual time only), a second allocation of the one-card pool is
     refused while the first holds it; the phase split (seconds, share,
     bytes, implied GB/s of host_sync against PEAK_BYTES_PER_S).
  35c. llama_8b: Llama-3-8B (the 8b preset: 4096 / 32 heads / 8 KV heads,
     head dim 128 / 32 layers / 14,336 ffn / 128,256 vocab) in bf16,
     seeded weights made on the card (~16 GB), placed by
     ComputeRuntime.place_params with llama_axes on a one-rank model
     mesh and served by the paged decoder on that mesh
     (LLAMA_8B_DECODER, a pool under 2 GB): LLAMA_8B_REQUESTS complete
     with their budgets, the pool drains, the paged kernel launches 32 x
     LLAMA_8B_DECODE_STEPS at head dim 128; tokens/s, round seconds, the
     TP-8 plan's per-rank bytes (LLAMA_8B_PLAN), one round profiled;
  35d. llama_8b_f32: the 8B widths at 2 layers in f32 on the mesh: the
     paged decoder's tokens against llama_greedy_decode;
  35e. agent_mesh: the agent phase's conversation through a
     ComputeRuntime over create_mesh({"model": 1}) (PE_LlamaAgent
     places with llama_axes): tokens, prefill and hit tokens, prefix
     admits, decode steps and launches equal the agent phase's.
  35f. agent_8b / agent_8b_f32: PE_LlamaAgent at Llama-3-8B on that
     mesh with sessions, the host tier, a shed, a drain (the counts
     AGENT_8B_*; the conversation's host-tier installs AGENT_8B_INSTALLS,
     async where an agreed kick landed at the note after it), and the
     f32 turns against llama_greedy_decode.
  35g. agent_mesh_modes: the agent on that mesh in batched mode (its
     default, the cut agreed by the runtime) at Llama-1B in bf16 and at
     AGENT_BATCHED_F32 layers in f32, against the same agent without a
     mesh (batches and tokens); then agent_disagg's drive with the agent
     over the mesh under the sync debug mode (rank 0's client decides,
     the note lands; its prefill side's decoder on the mesh too): its
     counts, tokens equal agent_disagg's, every installed block
     byte-equal to its shipped rows, 0 syncs.
  35h. asr_mesh: the pipeline phase's drive with its ComputeRuntime over
     create_mesh({"model": 1}): PE_WhisperASR places Whisper-small by
     whisper_axes through the runtime and runs its programs with the
     mesh, its batches cut by the runtime's agreement; its flash
     launches and every frame's tokens equal the pipeline phase's.
  35i. elements_mesh: PE_NeuralTTS (base, Griffin-Lim) and
     PE_ImageClassify (ResNet-18 at 224) on a ComputeRuntime over
     create_mesh({"model": 1}), placed by tts_axes and resnet_axes and
     run with the mesh, against the same elements without one on
     ELEMENTS_MESH's short drives of the tts and classify phases'
     inputs: sample counts, totals, mel and Griffin-Lim audio within
     tts_f32's limits, class ids equal, confidences within
     CLASSIFY_TOL, no attention launch.
  35j. operator_scripts: the port's operator scripts through their entry
     points (aiko_services_tpu_torch/scripts/), each drive with the
     counts zeroed before it: chaos_soak's speech soak at its CLI
     defaults (seed 11, 8 frames) with both serving ComputeRuntimes and
     the caller's log-mel on the card (every frame recovered, the
     faults the CPU run injects on that seed, no attention launch: the
     test preset's bucket 200 is below FLASH_MIN_SEQ); its migrate soak
     at Llama-1B's widths in f32 (the 1b preset's dtype: the stitched
     output is held bit for bit against a decode never preempted; the
     report's ok, and its paged launches); disagg_smoke at Llama-1B's
     widths cut to 4 of its 16 layers, with a 0.2 s window (its burst timer never fires: the transfers are
     the warm-up's), the probe bit-identical, its decoders dense as the
     script builds them (no paged launch).  Counts: OPERATOR_SCRIPTS.
  35k. golden: the golden trained speech models (tests/torch_golden.py,
     reached through sys.path, the recipes of tests/test_speech_golden.py
     and tests/test_tts.py, the Whisper one also on the mel the fused
     mu-law frontend computes): the tone-language Whisper and TTS trained on
     the card in f32, saved as flat npz files and served in bf16 through
     the port's pipeline (PE_AudioReadFile → PE_LogMel → PE_WhisperASR):
     the known wavs give "charlie alpha" and "bravo", the fused mu-law
     frontend and int8 cross-KV "charlie alpha" (stripped, as JAX's
     gates strip); PE_NeuralTTS speaks each word's tone (dominant
     frequency within 60 Hz, 2,400-8,000 samples).  The training s/step,
     steps taken and final losses, each served text's tokens and the
     f32 model's smallest top-2 logit gap along its greedy tokens; no
     attention launch (head dim 16, bucket 100: under FLASH_MIN_SEQ, in
     JAX too).  GOLDEN holds the recipe's texts;
  35l. examples: the repo's Python examples' port runners
     (aiko_services_tpu_torch/examples/) through their main() with
     --self-test, host only, on the real clock: aloha_honua, xgo_robot and
     robot_control print what the JAX scripts print (EXAMPLE_LINES); no
     attention launch.
  36. grad_guard: each of the three kernel wrappers raises on a CUDA
     operand that requires grad (the kernels have no backward) and
     launches nothing doing so.
  37. train: Whisper-small at its published widths (12 + 12 layers, 768
     wide, vocabulary 51,865, audio context 1500 from 3000 mel frames),
     f32 parameters with seeded weights, AdamW with optax's defaults
     (train.adamw), batch 4 with 64 target tokens, 5 steps on one batch
     through init_train_state / make_train_step on a one-rank NCCL mesh:
     every loss finite, the last below the first, state.step 5, no
     flash launch (context 1500 is not a multiple of 128); ms a step
     after the first and peak memory.
  38. train_f32: the widths at 2 + 2 layers (context 500), TF32 off, 3
     steps on the card against the same 3 steps on the CPU: losses and
     every parameter within TRAIN_F32_LOSS_RTOL / TRAIN_F32_STEP_SHARE.
  38b. train_mesh: those widths, 3 steps on the card unsharded and 3 on
     a one-rank mesh {model: 1} (parameters placed by whisper_axes, the
     forward and the vocab-parallel loss called with the mesh), f32:
     losses and parameters within train_f32's limits, bit equality
     recorded.
  39. checkpoint: that model on the card, 3 steps, save_checkpoint, 2
     more; a fresh state restored from the save and run 2 steps equals
     the uninterrupted run, parameters and both AdamW moments, within
     CHECKPOINT_RTOL (cuDNN's deterministic algorithms on).
  40. sp_prefill: llama_forward_sp on a one-rank seq mesh against
     llama_forward at 2048 tokens: Llama-1B in bf16 (argmax agreement at
     least SP_ARGMAX_MIN) and at 2 layers in f32 (within SP_F32_TOL).
  41. staged: StagedExecutor([encode, greedy_decode_from_audio]) with
     both stages on the card, Whisper-small in bf16 at bucket 3072, 3
     batches of 8: tokens and lengths equal to greedy_decode_scored's,
     12 flash launches a batch at the slice row's shape (they join that
     row's launches), in_flight 3 and then 0, and no host wait in
     submit(): it runs under torch.cuda's sync debug mode "error".
The kernel section holds the paged kernel at the verify shapes too: W =
3 (the split path) and W = 5 (the tensor cores) natively, W = 3 with
int8 pools folded; at the decode side's suffix extend after a shipped
cover (SUFFIX_EXTEND: 4 rows of a 64-token chunk, t_cap 512); and at
head dim 128: Llama-3-8B's decode (16 slots, 8 KV heads, G 4, t_cap 512,
P 16: llama_8b's launches), its extend (256 rows, P 64), the decode with
int8 pools folded, and a TP-8 rank's decode (one KV head).
The vision phases launch none of the three attention kernels, and they
need neither PIL nor OpenCV: every frame is posted at the element's size.
The 1b preset is f32 in the port as in JAX; the agent and assistant
phases serve it in bf16 (agent_preset), agent_f32 at 2 layers in f32.
The TTS phases launch none of the three attention kernels (S <= 128);
llama_moe's paged launches join the decode row of the kernels line.
Every earlier phase's launch counts must equal EARLIER_COUNTS.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card the run fails before
printing any result.  Imports nothing of JAX.
"""

# a console script: its JSON lines are its output
# graft: disable-file=lint-print

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import torch

from aiko_services_tpu_torch.ops.attention import CROSS_TOLERANCE
from aiko_services_tpu_torch.ops.paged_attention import (
    SPLIT_PATH as PAGED_SPLIT_PATH, TENSOR_PATH as PAGED_TENSOR_PATH,
    TOLERANCE as PAGED_TOLERANCE)

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger
# of its bytes over the memory rate and its operations over the peak.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# A kernel's output against its plain version computed in f32 on the
# same input values.  Elementwise, per output x = sum_j p_j v_j / l:
#   |kernel - plain| <= u * |plain| + c * sum_j p_j |v_j| / l
# u is the output's rounding: 2^-8, bf16's unit roundoff, for the bf16
# outputs of flash and cross-decode; 0 for the paged kernel's f32 output.
# c bounds the kernel's own rounding inside the sum: the flash kernel
# rounds each probability to bf16 for the PV product (c = 2^-8), the
# cross-decode kernel and the paged kernel's split path (the decode rows)
# keep f32 throughout (c = 2^-12 leaves room for f32 sums over 20k keys);
# the paged kernel's tensor-core path (bf16, more than 16 rows: the
# extend rows) rounds each unnormalised probability to bf16 for PV, as
# flash does and as JAX and the plain version round their weights
# (c = 2^-8).  sum_j p_j |v_j| / l is the plain version run on |v|.
# Besides, the relative L2 error of the whole output stays under a
# per-kernel limit, about 2.5x the error that rounding alone gives for
# the bf16 outputs (flash: output and probabilities, ~2^-9 relative each;
# cross-decode: the output's ~2^-9.5; the paged tensor-core path: the
# probabilities', relative errors spread over [-2^-8, 2^-8], ~0.0012 rms,
# under its f32 output) and
# 1e-4 for the paged split path's f32 (one dropped key of T <= 1024 moves
# a row by ~1/sqrt(T)), so that one dropped or mis-weighted key per row
# fails.
BF16_U = 2 ** -8
KERNEL_TOLERANCE = {          # kernel: (u, c, relative L2 limit)
    "flash_attention": (BF16_U, 2 ** -8, 0.008),
    "cross_decode_attention": CROSS_TOLERANCE,
    "paged_decode_attention": (0.0, *PAGED_TOLERANCE[PAGED_SPLIT_PATH]),
    "paged_decode_attention_tensor_cores": (
        0.0, *PAGED_TOLERANCE[PAGED_TENSOR_PATH]),
}
# the paged kernel's int8 variants on the split path keep f32 from the
# loaded values on, as the native one does: the same model, held against
# the plain version run in f32 on the values the kernel sees (int8 values
# and f32 scales as they are when folding; the values rounded to bf16,
# round(q * round(s)), when dequantizing)
KERNEL_TOLERANCE["paged_decode_attention_int8_fold"] = \
    KERNEL_TOLERANCE["paged_decode_attention_int8_dequant"] = \
    KERNEL_TOLERANCE["paged_decode_attention"]
# encoder features through 12 bf16 layers, kernel against plain
# attention: each layer's attention differs by about the bf16 rounding of
# the probabilities (2^-9 relative), and 12 residual layers add a few of
# those up: relative L2 error of the features
ENCODER_REL_L2 = 0.03

FLASH_KERNEL_LINE = "aiko_services_tpu/ops/attention.py:21"
# the flash kernel's shape [B, H, S, D] in each phase that launches it:
# bucket 3072 (context 1536) padded to the element's max_batch (8 in the
# slice phase, the example definition's default 32 in the pipeline)
FLASH_SHAPES = {"slice": (8, 12, 1536, 64), "pipeline": (32, 12, 1536, 64),
                # the surface phase's greedy_decode on a batch of four
                "surface": (4, 12, 1536, 64),
                # a TP-2 rank's encoder attention at the pipeline's
                # batch: 6 of Whisper-small's 12 heads.  One card serves
                # one rank, so no phase launches it (the TP-2 ranks run
                # as gloo CPU ranks in tier-1)
                "tp2": (32, 6, 1536, 64)}
FLASH_NAMES = {"slice": "flash_attention", "pipeline": "flash_attention_b32",
               "surface": "flash_attention_b4", "tp2": "flash_attention_tp2"}
# each phase that launches flash, and the row (FLASH_SHAPES key) whose
# shape it must run at: the remote pipeline's server pads to the same
# max_batch of 32 as the local pipeline
FLASH_ROWS = {"slice": "slice", "surface": "surface", "pipeline": "pipeline",
              "remote_pipeline": "pipeline", "peer_pipeline": "pipeline",
              "peer_chaos": "pipeline", "staged": "slice",
              "asr_mesh": "pipeline"}
# Whisper-small (dim, heads, encoder layers, decoder layers, vocab)
WHISPER_SMALL = (768, 12, 12, 12, 51865)
# flash launches in peer_chaos: 12 x its bucket-3072 batches
PEER_CHAOS_FLASH = 36
# the surface phase: models.greedy_decode on four long inputs at bucket
# 3072; its flash launches from the CPU rehearsal (tools/chip_rehearsal.py
# surface): one encode, a launch per encoder layer
SURFACE = {"seconds": (25.0, 27.0, 28.5, 30.0), "frames": 3072,
           "max_tokens": 24, "seed": 5, "timed_calls": 3}
SURFACE_FLASH = 12
# the counts every earlier phase gives (flash in slice, pipeline and the
# remote and peer phases, the paged kernel natively and its two int8
# variants; agent_tiered's decode and extend launches, llama_wq's two
# runs', decoder_chaos's, the disagg phase's two probes', the three
# disagg_variants probes', agent_disagg's, agent_migrate's and the ops
# phase's 16 x OPS_DECODE_STEPS, from the
# CPU rehearsals of their drives)
EARLIER_COUNTS = {"slice": 12, "surface": SURFACE_FLASH,
                  "pipeline": 24, "remote_pipeline": 24,
                  "peer_pipeline": 24, "peer_chaos": PEER_CHAOS_FLASH,
                  "llama": 5216, "int8_fold": 1920, "int8_dequant": 192,
                  "agent_tiered": 16 * (112 + 5),
                  # llama_wq and decoder_chaos at 8 of 16 layers since
                  # PR 25 (LLAMA_CUT_LAYERS; the script's time)
                  "llama_wq": 2 * 8 * 326, "decoder_chaos": 8 * (414 + 6),
                  "disagg_probe": 16 * (16 + 4) + 16 * (16 + 1 + 4),
                  "disagg_variants": 3 * 16 * (16 + 1 + 4),
                  "agent_disagg": 16 * (128 + 9 + 9),
                  "agent_migrate": 16 * (100 + 4),
                  # agent_migrate's drive with B on a one-rank model
                  # mesh, and the TTS and classify elements there (no
                  # attention kernel)
                  "agent_migrate_mesh": 16 * (100 + 4),
                  "elements_mesh": 0,
                  # the migrate soak's paged launches (OPERATOR_SCRIPTS)
                  "operator_scripts": 16 * 55,
                  "ops": 16 * 160,
                  # the pipeline's drive on a one-rank model mesh: the
                  # pipeline phase's 2 bucket-3072 batches
                  "asr_mesh": 24,
                  # the golden models (head dim 16, bucket 100) and the
                  # host-only examples launch no attention kernel
                  "golden": 0, "examples": 0}
# peer_chaos: the caller's channel drops a fifth of its request
# envelopes, the server's delays half of its replies by 0.2 s; a hop
# whose 3 s lease expires is sent again, up to 4 times.  Each side's
# plan has its own seed (random.Random(0) draws nothing under 0.2 in its
# first 16 draws: the run would inject no drop)
PEER_CHAOS = {
    "seeds": (2, 1),
    "caller_rules": (("drop", {"topic": "{server}", "probability": 0.2}),),
    "serving_rules": (("delay", {"topic": "{caller}", "probability": 0.5,
                                 "delay": 0.2}),),
    "retries": 4, "timeout": 3.0}
# the CLI child: Whisper-small's ~241 M parameters take ~0.48 GB in bf16
CLI_MIN_FALL_GB = 0.45
CLI_TIMEOUT_S = 240.0
CROSS_KERNEL_LINE = "aiko_services_tpu/ops/attention.py:164"
PAGED_KERNEL_LINE = "aiko_services_tpu/ops/paged_attention.py:59"

# the Llama slice's decoder (bench.py's 1b preset geometry) and traffic
LLAMA_DECODER = {"max_slots": 16, "steps_per_sync": 16, "kv_block": 32,
                 "prefill_buckets": (128,), "max_seq": 1024,
                 "paged_kv": True}
# Llama-3-8B (the 8b preset, head dim 128) served by the paged decoder on
# a one-rank model mesh (phases llama_8b and llama_8b_f32): 8 seeded
# requests of 64 prompt and 64 new tokens on 16 slots; LLAMA_8B_DECODE_STEPS
# from the CPU rehearsal of the drive (a 64-wide stand-in keeps the
# schedule: it depends on the request lengths alone); the per-rank plan
# of the JAX package's 8B agent (TP 8, 32 slots x 2,048 positions)
LLAMA_8B_DECODER = {"max_slots": 16, "steps_per_sync": 16, "kv_block": 32,
                    "prefill_buckets": (64,), "max_seq": 1024,
                    "paged_kv": True}
LLAMA_8B_REQUESTS = {"count": 8, "prompt": 64, "new": 64, "seed": 23}
LLAMA_8B_DECODE_STEPS = 64
LLAMA_8B_PLAN = {"tp": 8, "slots": 32, "positions": 2048}
# the agent on Llama-3-8B (phases agent_8b and agent_8b_f32): the agent
# phase's streams and turns through PE_LlamaAgent at the 8b preset on a
# one-rank model mesh, with sessions and the host KV tier as in
# agent_tiered (a prefix cache of AGENT_TIERED_BLOCKS blocks of the
# preset, every session demoted between turns) and 64-token prompt
# chunks, so every extend runs at row 3i's shape (G 4 x 64 rows a KV
# head, head dim 128).  Every frame carries a deadline 1e9 s away; one
# more request, submitted after the first turns with its deadline
# passed, is shed at the round note; after the turns a fourth turn on
# every stream is drained with a zero deadline after
# AGENT_8B_DRAIN_ROUNDS rounds, its live slots checkpointed and its
# queue evacuated, and resubmitted after resume.  The counts are a CPU
# rehearsal's (a 4-layer, 256-wide stand-in at head dim 128 with the
# same block count: the schedule depends on neither widths nor token
# values while the cache budget is in blocks)
AGENT_8B_OVERRIDES = {"preset": "8b", "prompt_length": 64}
AGENT_8B_HOST_MB = 1024
AGENT_8B_DRAIN_ROUNDS = 4
AGENT_8B_DECODE_STEPS = 116
AGENT_8B_EXTEND_DISPATCHES = 9
AGENT_8B_DRAIN = {"evacuated": 8, "checkpoints": 8}
# the conversation's host-tier installs (blocks), before the drained
# fourth turn and the closing promote_and_purge: a revived chain's
# promotion is kicked at the round note that agrees its arrival and lands
# at the next (async); the streams' chains start with the system
# preamble's shared blocks, so one kick a turn takes the first stream's
# chain, the other streams' admits wait for it and then stage what is
# left of their own chains on the host inline (sync)
AGENT_8B_INSTALLS = {"async": 11, "sync": 26}
EARLIER_COUNTS["agent_8b"] = 32 * (AGENT_8B_DECODE_STEPS +
                                   AGENT_8B_EXTEND_DISPATCHES)
# int8 KV and chunked prefill: the JAX bench's conversation-rung decoder
# (bench.py:1605-1611) without its prefix cache
LLAMA_INT8_DECODER = {"max_slots": 16, "steps_per_sync": 8, "kv_block": 32,
                      "prefill_buckets": (64,), "prefill_chunk": 64,
                      "max_seq": 1024, "paged_kv": True,
                      "kv_cache_dtype": "int8"}
# the conversational agent (phases agent and agent_f32): a one-element
# pipeline (PE_LlamaAgent) with these parameters, Llama-1B (the 1b
# preset) served through the paged decoder with the prefix cache and the
# session table.  The cache holds 256 MB: a Llama-1B block of 32 tokens
# takes 1 MiB in bf16, and 8 conversations of three turns keep ~120
# blocks; the element's default of 64 MB would refuse part of each
# harvest, so the schedule would depend on the model's widths
AGENT_PARAMETERS = {"preset": "1b", "mode": "continuous", "paged": True,
                    "prefix_block": 32, "sessions": True, "max_batch": 8,
                    "max_tokens": 32, "prompt_length": 128,
                    "steps_per_sync": 4, "session_lease": 30.0,
                    "prefix_cache_mb": 256}
AGENT_STREAMS, AGENT_TURNS, AGENT_SEED = 8, 3, 7
# every stream's first turn opens with this system preamble (the
# element's byte tokenizer keeps a turn's first 120 bytes, so turn 1 is
# the preamble's first 120 bytes on every stream); each turn's user text
# is 40-120 bytes of seeded words
AGENT_PREAMBLE = (
    "You are the operations assistant of a speech pipeline. Answer in "
    "short sentences, name the stream you speak about, keep numbers "
    "exact, and say when a measurement is missing instead of guessing.")
AGENT_TEXT_BYTES = (40, 121)
AGENT_WORDS = ("stream", "latency", "the", "batch", "card", "queue", "why",
               "is", "slow", "frames", "tokens", "show", "me", "now",
               "second", "window", "audio", "model", "drop", "retry")
# decode steps and extend dispatches of the agent phase's run, from a CPU
# rehearsal of the phase (the same drive on the same virtual clock with a
# narrow stand-in of the preset: the schedule does not depend on the
# widths or the token values); the paged kernel launches 16 x each
AGENT_DECODE_STEPS = 128
AGENT_EXTEND_DISPATCHES = 9
# turns 2 and 3 of every stream admit through the cache
AGENT_MIN_PREFIX_ADMITS = 2 * AGENT_STREAMS
# the assistant example: the element parameters this run overrides
# (everything else as the file has it), 4 streams of 3 five-second chunks
ASSISTANT_OVERRIDES = {"PE_LlamaAgent.preset": "1b",
                       "PE_LlamaAgent.paged": True,
                       "PE_LlamaAgent.prefix_block": 32,
                       "PE_LlamaAgent.sessions": True}
ASSISTANT_STREAMS, ASSISTANT_CHUNKS = 4, 3
ASSISTANT_MIN_PREFIX_ADMITS = 2 * ASSISTANT_STREAMS
# the agent's chunk extend at the paged kernel (row
# paged_decode_attention_extend_512): 8 slots, 8 KV heads, G = 4 x a
# 128-token chunk = 512 query rows, the chunk as the side buffer (P =
# 128), offsets from [0, 1024], a table at t_cap 1280
EXTEND_512 = {"slots": 8, "chunk": 128, "max_offset": 1024, "t_cap": 1280}
# speculative decoding (phases llama_spec, llama_spec_int8, decoder_f32):
# the prompt-lookup drafter matches bigrams and proposes k tokens; the
# verify runs the paged kernel at W = 1 + k query positions a slot (G x W
# rows a KV head: 12 for k = 2, the split path; 20 for k = 4, the
# tensor-core path) over a side buffer of steps_per_sync x W entries
SPEC_KS, SPEC_NGRAM = (2, 4), 2
# llama_dense and llama_spec serve the llama phase's traffic at 8 of
# Llama-1B's 16 layers (the depth cut that keeps the script inside its
# time since agent_migrate_mesh and elements_mesh joined it): their
# tokens are held against the paged decoder's at that depth (the
# LogitGaps run), not against the llama phase's
LLAMA_CUT_LAYERS = 8
# decoder_f32: the four decoders held against llama_greedy_decode
F32_DECODERS = {"dense": {"paged_kv": False},
                "dense_spec2": {"paged_kv": False, "speculate_k": 2},
                "paged_spec2": {"speculate_k": 2},
                "paged_spec4": {"speculate_k": 4}}
# llama_int8_f32: a first token mismatch against the CPU run passes only
# where the CPU run's top-2 logit gap there is below this.  Two f32 runs
# that sum in other orders store K/V that differ by an ulp or so, and
# where a value sits at a rounding boundary of its int8 code that ulp
# moves the code by one: a change of one scale (max|x| / 127, ~2% of a
# row's largest value) in one stored element.  The run prints the
# largest top-1 logit difference of the two runs before any mismatch
# (the drift) and the smallest top-2 gap of the CPU run: on an H100 they
# were 5.2e-4 and 5.1e-3.  The limit sits about 4x above that drift and
# below that smallest gap, so a token whose gap is wider than any drift
# seen must match.
INT8_TIE_GAP = 2e-3
# the vision path (phases detect, detect_dct8, detect_f32, classify).
# detect: the example's own parameters (detector_r18, 256 x 256,
# max_batch 32, pipelined, max_in_flight 4, f32) on DETECT_STREAMS x
# DETECT_FRAMES seeded frames (the repo holds no video file); dct8 keeps
# DCT_KEEP coefficients a block
DETECT_STREAMS, DETECT_FRAMES, DETECT_SIZE, DETECT_SEED = 8, 16, 256, 11
DETECT_MAX_IN_FLIGHT = 4
DCT_KEEP = 16
DETECT_TIMEOUT_S = 120.0
DETECT_THRESHOLD = 0.3          # PE_Detect's score_threshold default
# detect_f32: the card (f32, cuDNN's TF32 off) against the CPU on the
# same weights and frames.  Scores are sigmoids in [0.3, 1] and boxes are
# pixels at 256: f32 sums in other orders move them by ~1e-6 and ~1e-4;
# the limits leave ~100x of that.  A first difference in a frame's
# ranking passes only where the CPU's scores at that rank are within
# DETECT_TIE of each other (a tie the card may order either way)
DETECT_F32_STREAMS, DETECT_F32_FRAMES = 2, 8
DETECT_SCORE_TOL, DETECT_BOX_TOL, DETECT_TIE = 1e-4, 1e-2, 1e-4
# classify: ResNet-18 at 224, 1000 classes, f32, 64 frames; confidences
# (softmax maxima ~1e-2 on random weights) against the CPU's within
# CLASSIFY_TOL; a CPU top-2 probability gap under CLASSIFY_TIE is a tie
CLASSIFY_FRAMES, CLASSIFY_SEED = 64, 13
CLASSIFY_TOL, CLASSIFY_TIE = 1e-5, 1e-6
# elements_mesh: PE_NeuralTTS and PE_ImageClassify on a one-rank model
# mesh against the same elements without one, on the first
# classify_frames of classify's frames and tts_streams x TTS_TEXTS of
# the tts phase's texts (its long first text among them)
ELEMENTS_MESH = {"tts_streams": 2, "classify_frames": 16}


# text to speech (phases tts, tts_f32 and the assistant's voice):
# PE_NeuralTTS at preset base (dim 128, 4 layers, max_tokens 128,
# max_frames 1024, f32), batched, max_batch 16, 32 Griffin-Lim rounds;
# TTS_STREAMS x TTS_TEXTS seeded texts of 8-128 bytes, the first
# TTS_LONG_BYTES long (past max_tokens: truncation binds)
TTS_PARAMETERS = {"preset": "base", "mode": "batched", "max_batch": 16,
                  "gl_iters": 32}
TTS_STREAMS, TTS_TEXTS, TTS_SEED, TTS_LONG_BYTES = 16, 4, 17, 200
TTS_TIMEOUT_S = 120.0
# tts_f32: TTS_F32_STREAMS x TTS_TEXTS of those texts on the card and on
# the CPU port.  A total is the f32 cumsum of up to 128 durations, ~1,000
# frames for most texts, where one f32 ulp is 6e-5-1.2e-4: two sums in
# another order differ by a few ulps (2.4e-4 on an H100), so totals agree
# within TTS_TIE + TTS_TOTAL_REL x the total (~16 ulps), and a voiced
# length one frame off passes only where the total lies that close to an
# integer (ceil may go either way).  The other limits come from the CPU
# port against JAX (tests/test_torch_tts.py): mel ~2e-6 of its largest
# value, the vocoder's waveform ~1.4e-6 relative.  Griffin-Lim is
# chaotic at this model's size: each round re-derives the phase from
# the last one's FFTs, and on the CPU a 1e-7 relative change of the
# base preset's magnitudes moves the STFT magnitudes of the 32-round
# result by 1.8e-2 relative L2 (the waveform by 8e-2); the CPU port
# against JAX at the base preset measured 1.1e-2.  Each limit leaves ~3x
# or more over its measurement
TTS_F32_STREAMS = 2
TTS_TIE, TTS_TOTAL_REL, TTS_MEL_REL_L2 = 1e-4, 1e-6, 1e-4
TTS_GL_STFT_REL_L2, TTS_VOCODER_REL_L2 = 5e-2, 1e-4
# media: 4 chunks of 0.25 s (4,000 samples) from PE_MicrophoneSim; the
# card's f32 rfft against numpy's f64 one, max error / max magnitude
MEDIA_CHUNK_S, MEDIA_CHUNKS, MEDIA_FFT_REL = 0.25, 4, 1e-5
# the MoE Llama (phases llama_moe, llama_moe_f32): 8x1b (Llama-1B's
# widths, 8 experts of 8192, top 2).  llama_moe serves LLAMA_MOE_REQUESTS
# of the llama phase's requests through its decoder, r0 onwards (its
# 320-token "long" request left out: the phase's depth cut, which keeps
# the script inside its time); its decode steps are a CPU rehearsal's
# (tools/chip_rehearsal_mesh.py: a narrow stand-in, the schedule
# depending on neither widths nor token values, no request stopping
# early)
LLAMA_MOE_REQUESTS = 16
LLAMA_MOE_STEPS = 64
# llama_moe_f32: 16 requests of 16 new tokens, one slot each (capacity 5
# an expert at a decode step); a first split between the card and the
# CPU passes only where the CPU's top-2 logit gap or the smallest router
# top-k boundary gap of the program that emitted it lies under its limit
# (f32 sums in other orders move logits and router probabilities by
# ~1e-6: ~100x below)
MOE_F32_REQUESTS, MOE_F32_NEW = 16, 16
MOE_LOGIT_TIE, MOE_ROUTER_TIE = 1e-4, 1e-4
# the tiered agent (phases agent_tiered, agent_tiered_f32): the agent's
# parameters with a host KV tier of AGENT_TIERED_HOST_MB and a prefix
# cache of AGENT_TIERED_BLOCKS blocks (prefix_cache_mb from the preset's
# block bytes: 64 MiB for Llama-1B in bf16, under what eight
# conversations harvest, so LRU pressure demotes too).  The streams take
# their turns in lockstep, and between turns every session demotes
# through PrefixKVCache.demote_sessions, the hook the session table's
# expiry and demotion call (their own demotion drops the table's
# history, which the next turn needs): every stream's chain goes to
# pinned host memory, and its next turn prefetches it at the session
# touch and promotes it at the admit.  Decode steps and extend
# dispatches are a CPU rehearsal's (a narrow stand-in of the preset with
# the same block count; the schedule depends on neither widths nor
# token values)
AGENT_TIERED_HOST_MB, AGENT_TIERED_BLOCKS = 512, 64
AGENT_TIERED_DECODE_STEPS = 112
AGENT_TIERED_EXTEND_DISPATCHES = 5
# llama_wq: the llama phase's traffic through its decoder with
# weight_quant, then with fuse_projections; no request stops early, so
# each takes the llama phase's decode steps
LLAMA_WQ_STEPS = 326
# llama_select: the dense decoder in the select KV write; its inner loops
# at full width in f32 at 2 layers
SELECT_IMPLS = ("two_pass", "online", "vpu")
# decoder_chaos: Llama-1B (bf16) through the paged decoder with a prefix
# cache of 32-token blocks and prefill chunks of 128 (every extend then
# runs at the agent's 512-row shape), wrapped in ChaosDecoder: a
# preemption at CHAOS_PREEMPT_ROUND of the llama traffic, a pool-growth
# refusal of CHAOS_REFUSAL_ROUNDS rounds (the free list held dry), and a
# hung-scan watchdog (an injected clock adds CHAOS_HANG_S to one round);
# every fault drains with a deadline of 0 s, checkpoints the live slots
# into the cache, and the evacuated requests resume from prompt +
# generated after resume.  The counts are a CPU rehearsal's
CHAOS_DECODER = {**LLAMA_DECODER, "prefill_chunk": 128}
CHAOS_PREEMPT_ROUND, CHAOS_REFUSAL_ROUNDS = 4, 3
CHAOS_HANG_S, CHAOS_HANG_THRESHOLD_S = 5.0, 1.0
CHAOS_TENANTS = ("acme", "beta")
CHAOS_EVACUATED = 26
CHAOS_CHECKPOINTS = 16
CHAOS_DECODE_STEPS = 414
CHAOS_EXTEND_DISPATCHES = 6
# disaggregated serving (phases disagg, disagg_variants, disagg_f32): the
# JAX bench's lat_llama_disagg rung (bench.py:1788-1796) on Llama-1B in
# bf16 at max_seq_len 1024: 32-token blocks, 16 decode slots, 4 prefill
# slots, 4 steps a sync, buckets (64,), prefill chunks of 64, transfers
# timing out after 60 s; the probe (a 200-token prompt of seed 7, 16 new
# tokens) and measure(window 8 s, a burst every 0.4 s)
DISAGG_HARNESS = {"block_tokens": 32, "max_slots": 16, "prefill_slots": 4,
                  "steps_per_sync": 4, "prefill_buckets": (64,),
                  "prefill_chunk": 64, "transfer_timeout": 60.0,
                  "decoder_opts": {"paged_kv": True, "kv_block": 32}}
DISAGG_PROBE = {"tokens": 200, "seed": 7, "new": 16}
DISAGG_WINDOW, DISAGG_BURST_EVERY = 8.0, 0.4
# the probe's counts, from a CPU rehearsal (one request: the schedule
# depends on neither widths nor token values).  Disaggregated, the
# decode side installs the 6 complete blocks the prefill side streamed
# in 3 chunks
# (the final envelope then installs nothing new) and prefills the
# 8-token suffix; paged launches are 16 x (16 decode steps + the 4
# chunk extends, or the suffix extend and the prefill side's 4)
DISAGG_PROBE_COUNTS = {
    "colocated": {"tokens_prefill": 200, "prefix_admits": 0,
                  "paged_launches": 16 * (16 + 4)},
    "disaggregated": {"tokens_prefill": 8, "prefix_admits": 1,
                      "transfers": 1, "installs": 1, "installed_blocks": 0,
                      "chunk_installs": 3, "local_fallbacks": 0,
                      "paged_launches": 16 * (16 + 1 + 4)}}
PROBE_REMOTE = {"tokens_prefill": 8, "prefix_admits": 1, "transfers": 1,
                "installs": 1, "local_fallbacks": 0,
                "paged_launches": 16 * (16 + 1 + 4)}
DISAGG_VARIANT_COUNTS = {
    "int8": {**PROBE_REMOTE, "installed_blocks": 0, "direct_installs": 0,
             "chunk_installs": 3, "chunk_blocks": 6},
    "chunk_stream_off": {**PROBE_REMOTE, "installed_blocks": 6,
                         "direct_installs": 0, "chunk_installs": 0,
                         "chunk_blocks": 0},
    "cacheless": {**PROBE_REMOTE, "installed_blocks": 6,
                  "direct_installs": 1, "chunk_installs": 3,
                  "chunk_blocks": 6, "pool_blocks_after": 0}}
# agent_disagg: the agent's parameters with role "decode" and disagg
# true; its counts, from a CPU rehearsal of the drive
AGENT_DISAGG = {**AGENT_PARAMETERS, "role": "decode", "disagg": True}
AGENT_DISAGG_COUNTS = {"decode_steps": 128, "extend_dispatches": 9,
                       "prefill_extends": 9, "transfers": 24, "installs": 24,
                       "local_fallbacks": 0, "prefix_admits": 24,
                       "paged_launches": 16 * (128 + 9 + 9)}
# agent_migrate: 8 sessions of 80-160 seeded prompt tokens, 2 turns of 32
# new tokens (turn 2 adds 24 tokens) on side A, then turn 3 on B; its
# paged launches (16 x 100 decode steps + 16 x 4 extends), from a CPU
# rehearsal
MIGRATE = {"block": 32, "sessions": 8, "chunk_blocks": 8, "host_mb": 512,
           "prompt_tokens": (80, 161), "turn_tokens": 24, "new": 32,
           "seed": 21}
MIGRATE_LAUNCHES = 16 * (100 + 4)
# the decode side's suffix extend after a shipped cover, at the paged
# kernel (row paged_decode_attention_suffix_extend): a burst's 4 rows of
# a 64-token chunk (the harness's prefill_chunk: G = 4 x 64 = 256 query
# rows) at offsets 192 or 256 (a cover of 6 or 8 blocks), the chunk as
# the side buffer, a table at the decoder's t_cap of 512
SUFFIX_EXTEND = {"slots": 4, "chunk": 64, "offsets": (192, 256),
                 "t_cap": 512}

def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


# the native phase's seeded corpus
NATIVE_TOPICS, NATIVE_PAYLOADS = 20_000, 5_000


def _per_call_us(fn, cases) -> float:
    """Median over 5 passes of one pass's host microseconds a call."""
    passes = []
    for _ in range(5):
        start = time.perf_counter()
        for case in cases:
            fn(*case)
        passes.append((time.perf_counter() - start) / len(cases) * 1e6)
    return statistics.median(passes)


def phase_native() -> None:
    """The host extension: built, loaded, and held against its plain
    versions (transport/message.py _py_topic_matches, utils/sexpr.py
    _parse_sexpr_py) with no mismatch allowed; host times a call."""
    from aiko_services_tpu_torch import native
    from aiko_services_tpu_torch.transport.message import \
        _py_topic_matches
    from aiko_services_tpu_torch.utils.sexpr import _parse_sexpr_py

    start = time.perf_counter()
    if not native.NATIVE_AVAILABLE:
        raise AssertionError("native: the extension did not build or load "
                             "(g++ and Python's headers are needed)")
    build_s = time.perf_counter() - start
    pairs, payloads = native.parity_corpus(0, NATIVE_TOPICS,
                                           NATIVE_PAYLOADS)

    def outcome(parse, payload):
        try:
            return parse(payload)
        except ValueError as exc:
            return type(exc)

    topic_mismatches = sum(
        native.native_topic_matches(*pair) != _py_topic_matches(*pair)
        for pair in pairs)
    payload_mismatches = sum(
        outcome(native.native_parse_sexpr, payload) !=
        outcome(_parse_sexpr_py, payload) for payload in payloads)
    parsing = [(payload,) for payload in payloads
               if not isinstance(outcome(_parse_sexpr_py, payload), type)]
    record = {
        "phase": "native", "build_s": build_s,
        "library": native.build_path().name,
        "topic_pairs": len(pairs),
        "matched": sum(_py_topic_matches(*pair) for pair in pairs),
        "payloads": len(payloads), "parsed": len(parsing),
        "topic_mismatches": topic_mismatches,
        "payload_mismatches": payload_mismatches,
        "topic_us": {"native": _per_call_us(native.native_topic_matches,
                                            pairs),
                     "plain": _per_call_us(_py_topic_matches, pairs)},
        "sexpr_us": {"native": _per_call_us(native.native_parse_sexpr,
                                            parsing),
                     "plain": _per_call_us(_parse_sexpr_py, parsing)}}
    emit(record)
    if topic_mismatches or payload_mismatches:
        raise AssertionError(f"native: {topic_mismatches} topic and "
                             f"{payload_mismatches} payload mismatches")


@contextlib.contextmanager
def native_routing(phase: str):
    """Count the topics a phase routes through the native matcher (the
    dispatch of transport/message.py's topic_matches), and fail unless
    the phase routed some and the dispatch is the native one."""
    from aiko_services_tpu_torch import native
    from aiko_services_tpu_torch.transport import message

    message.topic_matches("aiko/+", "aiko/x")     # resolves the dispatch
    if message._impl_topic_matches is not native.native_topic_matches:
        raise AssertionError(f"{phase}: topic_matches dispatches to "
                             f"{message._impl_topic_matches!r}, not the "
                             f"native matcher")
    calls = [0]

    def counted(pattern: str, topic: str) -> bool:
        calls[0] += 1
        return native.native_topic_matches(pattern, topic)

    message._impl_topic_matches = counted
    try:
        yield
    finally:
        message._impl_topic_matches = native.native_topic_matches
    emit({"phase": f"{phase}_routing", "native_topic_matches": calls[0]})
    if not calls[0]:
        raise AssertionError(f"{phase}: no topic went through the native "
                             f"matcher")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def flush_l2(scratch) -> None:
    scratch.zero_()            # 128 MB write evicts the 50 MB L2


@functools.cache
def spin_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep's device spin per millisecond,
    measured once with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(2_000_000)
    end.record()
    end.synchronize()
    return 2e6 / start.elapsed_time(end)


def time_ms(fn, scratch, reps: int = 20, warmup: int = 3,
            host_ahead: bool = True) -> float:
    """Median device time of one call, cold L2, between two CUDA events
    that bracket device work alone.  After the L2 flush the stream spins
    on the card for 1 ms more than twice the call's host time (the median
    of the warm-up calls), so the host records the start event, runs the
    call's Python (checks, allocations, launches) and records the end
    event while the card is still spinning: the call's kernels then run
    back to back between the events.  host_ahead=False leaves the spin
    out, so the events also take in the host's time between launches
    (only to show what the spin removes)."""
    host = []
    for _ in range(warmup):
        begin = time.perf_counter()
        fn()
        host.append(time.perf_counter() - begin)
    torch.cuda.synchronize()
    spin = int((2e3 * statistics.median(host) + 1.0) * spin_cycles_per_ms())
    times = []
    for _ in range(reps):
        flush_l2(scratch)
        if host_ahead:
            torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    compute_ms = flops / PEAK_BF16_FLOPS * 1e3
    memory_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    if compute_ms >= memory_ms:
        return compute_ms, "operations"
    return memory_ms, "bytes"


def split_heads(x, heads: int):
    """[B, T, H*D] → [B, H, T, D] view, the layout layers.mha hands the
    attention functions."""
    b, t, _ = x.shape
    return x.view(b, t, heads, -1).permute(0, 2, 1, 3)


def compare(kernel: str, out, plain, plain_on_abs_v) -> dict:
    """The error of a kernel's output against its plain version (both
    callables take (q, k, v) in f32); raises beyond KERNEL_TOLERANCE."""
    torch.cuda.synchronize()
    u, c, rel_l2_limit = KERNEL_TOLERANCE[kernel]
    ref, magnitude = plain(), plain_on_abs_v()
    err = (out.float() - ref).abs()
    rel_l2 = (err.norm() / ref.norm()).item()
    # error over its elementwise bound: at most 1 passes
    bound_ratio = (err / (u * ref.abs() + c * magnitude)
                   .clamp_min(1e-30)).max().item()
    if not torch.isfinite(out).all() or bound_ratio > 1.0 or \
            rel_l2 > rel_l2_limit:
        raise AssertionError(
            f"{kernel}: kernel disagrees with its plain version (max abs "
            f"err {err.max().item()}, error / elementwise bound "
            f"{bound_ratio}, relative L2 {rel_l2}, limit {rel_l2_limit})")
    return {"max_abs_err": err.max().item(), "rel_l2": rel_l2,
            "rel_l2_limit": rel_l2_limit, "bound_ratio": bound_ratio}


def phase_kernels(device, generator) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes;
    returns one record per kernel (the causal flash case, an option the
    path does not take, is printed on its own line)."""
    import torch.nn.functional as F

    from aiko_services_tpu_torch.ops import attention as A

    scratch = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                          device=device)
    b, h, s, d = FLASH_SHAPES["slice"]

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    def record(name, source, replaces, errors, kernel, plain, library,
               flops, nbytes, shape):
        bound_ms, bound_by = bound(flops, nbytes)
        result = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": list(shape), **errors,
            "ms": time_ms(kernel, scratch),
            "plain_ms": time_ms(plain, scratch),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(library, scratch),
        }
        emit({"phase": "kernel", **result})
        return result

    # flash attention at the encoder's shape (bucket 3072: context 1536),
    # once per phase that launches it: [B, S, H*D] projections viewed as
    # heads, as layers.mha hands them; the causal case (an option the
    # path does not take) at the slice's batch only
    records = []
    cases = [(phase, shape, False) for phase, shape in FLASH_SHAPES.items()]
    cases.append(("slice", FLASH_SHAPES["slice"], True))
    for phase, (fb, fh, fs, fd), causal in cases:
        q, k, v = (split_heads(randn(fb, fs, fh * fd), fh) for _ in range(3))
        q32, k32, v32 = q.float(), k.float(), v.float()
        errors = compare(
            "flash_attention", A.flash_attention(q, k, v, causal=causal),
            lambda: A.flash_attention_reference(q32, k32, v32,
                                                causal=causal),
            lambda: A.flash_attention_reference(q32, k32, v32.abs(),
                                                causal=causal))
        del q32, k32, v32
        pairs = fs * (fs + 1) / 2 if causal else fs * fs   # keys a run needs
        name = FLASH_NAMES[phase]
        result = record(
            name + ("_causal" if causal else ""),
            "aiko_services_tpu_torch/csrc/flash_attention.cu",
            FLASH_KERNEL_LINE, errors,
            lambda: A.flash_attention(q, k, v, causal=causal),
            lambda: A.flash_attention_reference(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal),
            flops=4.0 * fb * fh * pairs * fd,
            nbytes=4.0 * fb * fh * fs * fd * 2, shape=(fb, fh, fs, fd))
        if not causal:
            result["counter"] = "flash_attention"
            result["counted_in"] = tuple(
                name for name, row in FLASH_ROWS.items() if row == phase)
            records.append(result)
        del q, k, v
        torch.cuda.empty_cache()

    # cross-decode attention at the decode tail's shapes: one query row
    # against the precomputed cross K/V of the 3072-frame bucket (T =
    # 1536) and of the 500-frame bucket (T = 250)
    for t in (s, 250):
        qd = split_heads(randn(b, 1, h * d), h)
        kd, vd = (split_heads(randn(b, t, h * d), h) for _ in range(2))
        qd32, kd32, vd32 = qd.float(), kd.float(), vd.float()
        errors = compare(
            "cross_decode_attention", A.cross_decode_attention(qd, kd, vd),
            lambda: A.cross_decode_attention_reference(qd32, kd32, vd32),
            lambda: A.cross_decode_attention_reference(qd32, kd32,
                                                       vd32.abs()))
        result = record(
            "cross_decode_attention" + ("" if t == s else f"_t{t}"),
            "aiko_services_tpu_torch/csrc/cross_decode_attention.cu",
            CROSS_KERNEL_LINE, errors,
            lambda: A.cross_decode_attention(qd, kd, vd),
            lambda: A.cross_decode_attention_reference(qd, kd, vd),
            lambda: F.scaled_dot_product_attention(qd, kd, vd),
            flops=4.0 * b * h * t * d,
            nbytes=(2.0 * b * h * t * d + 2.0 * b * h * d) * 2,
            shape=(b, h, t, d))
        result["counter"] = "cross_decode_attention"
        result["counted_in"] = ("slice", "pipeline")
        records.append(result)
    return records


def paged_case(generator, t_cap: int, side_len: int, block: int = 32,
               head_dim: int = 64, num_kv: int = 8):
    """Operands of one paged decode-attention call at the Llama slice's
    shape: max_slots slots, 8 KV heads, 4 query rows each (G = 4, W = 1),
    D = 64, bf16, a pool of shuffled blocks, extents from 1 to t_cap, a
    side buffer of side_len entries (the decoder's steps_per_sync) under
    a partial mask; head_dim and num_kv give Llama-3-8B's (D = 128) and
    a TP-8 rank's (one KV head)."""
    slots, groups = LLAMA_DECODER["max_slots"], 4
    nb = t_cap // block
    num_blocks = slots * nb + 1
    device = generator.device

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    k_pool, v_pool = (randn(num_blocks, num_kv, block, head_dim)
                      for _ in range(2))
    k_pool[0] = v_pool[0] = 0                     # the null block
    entries = torch.randint(1, t_cap + 1, (slots,), generator=generator,
                            device=device, dtype=torch.int32)
    ids = (torch.randperm(num_blocks - 1, generator=generator,
                          device=device) + 1).to(torch.int32).view(slots, nb)
    needed = (entries.long() + block - 1) // block
    past = torch.arange(nb, device=device)[None] >= needed[:, None]
    tables = ids.masked_fill(past, 0)             # past the extent: null
    side_valid = torch.rand((slots, 1, side_len), generator=generator,
                            device=device) < 0.5
    side_valid[:, :, 0] = True
    return (randn(slots, num_kv, groups, head_dim), k_pool, v_pool, tables,
            randn(slots, num_kv, side_len, head_dim),
            randn(slots, num_kv, side_len, head_dim), side_valid, entries)


def extend_case(generator, block: int = 32, head_dim: int = 64):
    """Operands of one chunk extend at the int8 Llama decoder's shape: 16
    rows of a 64-token chunk, 8 KV heads, 4 x 64 query rows each, D = 64
    (or head_dim), bf16; offsets (the pool extents) drawn from [0, 512],
    row 0's 0 (a first chunk); the chunk's own K/V as the side buffer
    under the causal triangle; the table at t_cap 768, null past offset
    + chunk."""
    chunk = LLAMA_INT8_DECODER["prefill_chunk"]
    slots, num_kv, groups, nb = 16, 8, 4, 768 // block
    num_blocks = slots * nb + 1
    device = generator.device

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    k_pool, v_pool = (randn(num_blocks, num_kv, block, head_dim)
                      for _ in range(2))
    k_pool[0] = v_pool[0] = 0
    offsets = torch.randint(0, 513, (slots,), generator=generator,
                            device=device, dtype=torch.int32)
    offsets[0] = 0
    ids = (torch.randperm(num_blocks - 1, generator=generator,
                          device=device) + 1).to(torch.int32).view(slots, nb)
    needed = (offsets.long() + chunk + block - 1) // block
    past = torch.arange(nb, device=device)[None] >= needed[:, None]
    tables = ids.masked_fill(past, 0)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=device).tril()
    side_valid = tri.expand(slots, chunk, chunk).contiguous()
    return (randn(slots, num_kv, groups * chunk, head_dim), k_pool, v_pool,
            tables, randn(slots, num_kv, chunk, head_dim),
            randn(slots, num_kv, chunk, head_dim), side_valid, offsets)


def extend512_case(generator, block: int = 32):
    """Operands of one chunk extend at the agent's shape (EXTEND_512): 8
    slots, 8 KV heads, 4 x 128 query rows each, D = 64, bf16; the
    chunk's own K/V as the side buffer under the causal triangle;
    offsets (the pool extents) drawn from [0, 1024].  Slot 1 aliases
    slot 0's first four blocks (a cached prefix two slots share) and its
    offset, 96, lies inside them, as a hit that slides back does."""
    chunk, slots = EXTEND_512["chunk"], EXTEND_512["slots"]
    num_kv, groups, nb = 8, 4, EXTEND_512["t_cap"] // block
    num_blocks = slots * nb + 1
    device = generator.device

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    k_pool, v_pool = (randn(num_blocks, num_kv, block, 64) for _ in range(2))
    k_pool[0] = v_pool[0] = 0
    offsets = torch.randint(0, EXTEND_512["max_offset"] + 1, (slots,),
                            generator=generator, device=device,
                            dtype=torch.int32)
    offsets[1] = 96
    ids = (torch.randperm(num_blocks - 1, generator=generator,
                          device=device) + 1).to(torch.int32).view(slots, nb)
    ids[1, :4] = ids[0, :4]
    needed = (offsets.long() + chunk + block - 1) // block
    past = torch.arange(nb, device=device)[None] >= needed[:, None]
    tables = ids.masked_fill(past, 0)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=device).tril()
    side_valid = tri.expand(slots, chunk, chunk).contiguous()
    return (randn(slots, num_kv, groups * chunk, 64), k_pool, v_pool,
            tables, randn(slots, num_kv, chunk, 64),
            randn(slots, num_kv, chunk, 64), side_valid, offsets)


def suffix_case(generator, block: int = 32):
    """Operands of the decode side's suffix extend (SUFFIX_EXTEND): 4
    rows of a 64-token chunk, 8 KV heads, 4 x 64 query rows each, D =
    64, bf16; offsets drawn from SUFFIX_EXTEND["offsets"]; the chunk's
    own K/V as the side buffer under the causal triangle; the table at
    t_cap 512, null past offset + chunk."""
    chunk, slots = SUFFIX_EXTEND["chunk"], SUFFIX_EXTEND["slots"]
    num_kv, groups, nb = 8, 4, SUFFIX_EXTEND["t_cap"] // block
    num_blocks = slots * nb + 1
    device = generator.device

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    k_pool, v_pool = (randn(num_blocks, num_kv, block, 64) for _ in range(2))
    k_pool[0] = v_pool[0] = 0
    choice = torch.randint(0, len(SUFFIX_EXTEND["offsets"]), (slots,),
                           generator=generator, device=device)
    offsets = torch.tensor(SUFFIX_EXTEND["offsets"], dtype=torch.int32,
                           device=device)[choice]
    ids = (torch.randperm(num_blocks - 1, generator=generator,
                          device=device) + 1).to(torch.int32).view(slots, nb)
    needed = (offsets.long() + chunk + block - 1) // block
    past = torch.arange(nb, device=device)[None] >= needed[:, None]
    tables = ids.masked_fill(past, 0)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=device).tril()
    side_valid = tri.expand(slots, chunk, chunk).contiguous()
    return (randn(slots, num_kv, groups * chunk, 64), k_pool, v_pool,
            tables, randn(slots, num_kv, chunk, 64),
            randn(slots, num_kv, chunk, 64), side_valid, offsets)


def verify_case(generator, width: int, steps: int, t_cap: int,
                block: int = 32):
    """Operands of one speculative verify call at the Llama decoder's
    shape: 16 slots, 8 KV heads, 4 x W query rows (G = 4, W = 1 + k),
    D = 64, bf16, extents from [1, t_cap]; a side buffer of `steps`
    (the decoder's steps_per_sync) x W entries as it stands at a round's
    last step: each earlier block kept 1 to W of its positions (the rest
    invalid), the last block live, under the causal mask pos_side <=
    q_pos."""
    _, k_pool, v_pool, tables, k_side, v_side, _, entries = paged_case(
        generator, t_cap, steps * width, block)
    slots, num_kv = k_side.shape[:2]
    device = generator.device
    invalid = 1 << 30
    cols = torch.arange(width, device=device)[None]
    pos_side = torch.full((slots, steps * width), invalid,
                          dtype=torch.int32, device=device)
    lengths = entries.long()
    for step in range(steps):
        q_pos = lengths[:, None] + cols
        block_pos = slice(step * width, (step + 1) * width)
        if step == steps - 1:
            pos_side[:, block_pos] = q_pos
            break
        kept = torch.randint(1, width + 1, (slots, 1), generator=generator,
                             device=device)
        pos_side[:, block_pos] = torch.where(cols < kept, q_pos, invalid)
        lengths = lengths + kept[:, 0]
    side_valid = (pos_side[:, None, :] <= q_pos[:, :, None]).contiguous()
    q = torch.randn(slots, num_kv, 4 * width, 64, generator=generator,
                    device=device).to(torch.bfloat16)
    return q, k_pool, v_pool, tables, k_side, v_side, side_valid, entries


def int8_pool(pool):
    """The int8 serving form of a bf16 pool (null block all zeros)."""
    from aiko_services_tpu_torch.models.layers import quantize_kv_cache
    leaf = quantize_kv_cache(pool)
    leaf["s"][0] = 0
    return leaf


def phase_paged_kernel(generator, head_dim: int = 64) -> list[dict]:
    """The paged kernel against its plain version, in its three numerics:
    natively and with int8 pools (scales folded) at the decode shape,
    t_cap 256 and 512; with int8 pools dequantized and natively at the
    extend shape; head_dim 128: the rows of Llama-3-8B's shapes (their
    libraries build while the earlier phases run).  Returns every
    record, for the kernels line.
    library_ms: scaled_dot_product_attention
    over K/V gathered (and dequantized) contiguously beforehand and a
    boolean mask built beforehand (excluded from the time)."""
    import torch.nn.functional as F

    import numpy as np

    from aiko_services_tpu_torch.models.layers import (dequantize_kv_cache,
                                                       gather_paged_kv)
    from aiko_services_tpu_torch.ops import paged_attention as P

    scratch = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                          device=generator.device)

    if head_dim == 64:
        # the timer on a call that does the wrapper's host work (its
        # checks and its output allocation) and launches nothing: ~0 ms
        # with the host ahead of the card, the host's time without
        # (operands from a generator of their own, so the rows below keep
        # theirs)
        idle = paged_case(
            torch.Generator(device=generator.device).manual_seed(1), 256,
            LLAMA_DECODER["steps_per_sync"])

        def host_only():
            kq, ks, vq, vs = P._check_planes(idle[1], idle[2])
            P._check_operands(idle[0], kq, ks, vq, vs, *idle[3:], 4)
            torch.empty(idle[0].shape, dtype=torch.float32,
                        device=idle[0].device)

        emit({"phase": "timer",
              "host_only_call_ms": time_ms(host_only, scratch),
              "host_only_call_ms_without_spin": time_ms(
                  host_only, scratch, host_ahead=False),
              "spin_cycles_per_ms": spin_cycles_per_ms()})

    def measure(name, variant, operands, groups, fold, extra):
        q, k_pool, v_pool, tables, k_side, v_side, side_valid, entries = \
            operands
        int8 = isinstance(k_pool, dict)
        head_dim = q.shape[-1]
        # the wrapper's default scale, f32(1) / sqrt(f32(D))
        scale = float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))
        # the plain version in f32 on the values the kernel sees
        if int8 and not fold:
            plain_k, plain_v = (dequantize_kv_cache(leaf, q.dtype).float()
                                for leaf in (k_pool, v_pool))
        elif int8:
            plain_k, plain_v = k_pool, v_pool
        else:
            plain_k, plain_v = k_pool.float(), v_pool.float()
        q32, ks32, vs32 = q.float(), k_side.float(), v_side.float()

        def plain_f32(abs_v=False):
            v_main, v_s = plain_v, vs32
            if abs_v:
                v_main = dict(v_main, q=v_main["q"].abs()) \
                    if isinstance(v_main, dict) else v_main.abs()
                v_s = vs32.abs()
            return P.paged_decode_attention_reference(
                q32, plain_k, v_main, tables, ks32, v_s, side_valid,
                entries, groups=groups, scale=scale, fold_scales=fold)

        slots, num_kv, rows, _ = q.shape
        tensor_cores = P.kernel_plan(True, slots, num_kv, rows, 1, 1)[0] \
            == P.TENSOR_PATH
        errors = compare(
            "paged_decode_attention_tensor_cores" if tensor_cores
            else variant,
            P.paged_decode_attention(*operands, groups=groups,
                                     fold_scales=fold),
            plain_f32, lambda: plain_f32(abs_v=True))
        # SDPA's operands, made outside the timed call
        k_all = torch.cat([dequantize_kv_cache(
            gather_paged_kv(k_pool, tables), q.dtype), k_side], dim=2)
        v_all = torch.cat([dequantize_kv_cache(
            gather_paged_kv(v_pool, tables), q.dtype), v_side], dim=2)
        width = side_valid.shape[1]
        block = (k_pool["q"] if int8 else k_pool).shape[2]
        main_t = tables.shape[1] * block
        main_ok = torch.arange(main_t, device=q.device)[None] < \
            entries[:, None]
        side_rows = side_valid[:, torch.arange(rows, device=q.device) %
                               width]                    # [S, rows, P]
        mask = torch.cat([main_ok[:, None].expand(-1, rows, -1), side_rows],
                         dim=-1)[:, None]
        # bytes and operations this run's data needs: the blocks each
        # slot's extent covers (1 byte a value and 4 a position for the
        # scales when int8), the side buffer, q, the table and the f32
        # output; a product per (query row, covered position) and per
        # visible (query row, side entry)
        positions = int(((entries.long() + block - 1) // block).sum()) * \
            block
        per_position = head_dim + 4 if int8 else head_dim * 2
        nbytes = (q.numel() * 2 + 2 * positions * num_kv * per_position +
                  2 * k_side.numel() * 2 + side_valid.numel() +
                  tables.numel() * 4 + entries.numel() * 4 +
                  slots * num_kv * rows * head_dim * 4)
        side_pairs = int(side_valid.sum()) * groups
        flops = 4.0 * num_kv * head_dim * (rows * positions + side_pairs)
        bound_ms, bound_by = bound(flops, nbytes)
        record = {
            "name": name, "route": "cuda",
            "source": "aiko_services_tpu_torch/csrc/"
                      "paged_decode_attention.cuh",
            "replaces": PAGED_KERNEL_LINE, "variant": variant, **extra,
            "shape": list(q.shape), **errors,
            "ms": time_ms(lambda: P.paged_decode_attention(
                *operands, groups=groups, fold_scales=fold), scratch),
            "plain_ms": time_ms(lambda: P.paged_decode_attention_reference(
                *operands, groups=groups, scale=scale, fold_scales=fold),
                scratch),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k_all, v_all, attn_mask=mask), scratch),
        }
        emit({"phase": "kernel", **record})
        return record

    if head_dim == 128:
        return d128_rows(generator, measure)
    # each row at the side-buffer length of the decoder that runs it:
    # the native decoder's steps_per_sync (16), the int8 one's (8);
    # "path" keys the launches the smoke's decoders make at that shape
    records = []
    for t_cap in (256, 512):
        suffix = "" if t_cap == 256 else f"_t{t_cap}"
        operands = paged_case(generator, t_cap,
                              LLAMA_DECODER["steps_per_sync"])
        records.append(measure("paged_decode_attention" + suffix,
                               "paged_decode_attention", operands, 4, True,
                               {"t_cap": t_cap, "path": "decode"}))
        quantized = list(paged_case(generator, t_cap,
                                    LLAMA_INT8_DECODER["steps_per_sync"]))
        quantized[1], quantized[2] = int8_pool(quantized[1]), \
            int8_pool(quantized[2])
        records.append(measure("paged_decode_attention_int8_fold" + suffix,
                               "paged_decode_attention_int8_fold", quantized,
                               4, True, {"t_cap": t_cap, "path": "decode"}))
    operands = extend_case(generator)
    quantized = list(operands)
    quantized[1], quantized[2] = int8_pool(operands[1]), \
        int8_pool(operands[2])
    records.append(measure("paged_decode_attention_int8_dequant",
                           "paged_decode_attention_int8_dequant", quantized,
                           4, False, {"t_cap": 768, "path": "extend"}))
    # no smoke decoder extends into a native pool at this shape: this
    # row's launches stay 0
    records.append(measure("paged_decode_attention_extend",
                           "paged_decode_attention", operands, 4, False,
                           {"t_cap": 768, "path": "extend"}))
    # the agent's extend: two 256-row tiles a (slot, KV head), a 128-entry
    # side buffer under the per-query mask at W = 128; its launches are
    # the agent phase's extends
    records.append(measure("paged_decode_attention_extend_512",
                           "paged_decode_attention", extend512_case(generator),
                           4, False, {"t_cap": EXTEND_512["t_cap"],
                                      "path": "extend_512"}))
    # the speculative verify at W = 1 + k: k = 2 on the split path, k = 4
    # on the tensor cores, natively at the llama_spec decoder's shape
    # (16 steps a sync, t_cap 512); k = 2 with int8 pools, scales folded,
    # at the llama_spec_int8 decoder's (8 steps a sync, t_cap 768)
    for k in SPEC_KS:
        records.append(measure(
            f"paged_decode_attention_verify_w{k + 1}",
            "paged_decode_attention",
            verify_case(generator, k + 1, LLAMA_DECODER["steps_per_sync"],
                        512), 4, True,
            {"t_cap": 512, "path": f"verify_w{k + 1}"}))
    quantized = list(verify_case(generator, 3,
                                 LLAMA_INT8_DECODER["steps_per_sync"], 768))
    quantized[1], quantized[2] = int8_pool(quantized[1]), \
        int8_pool(quantized[2])
    records.append(measure("paged_decode_attention_int8_fold_verify_w3",
                           "paged_decode_attention_int8_fold", quantized, 4,
                           True, {"t_cap": 768, "path": "verify_w3"}))
    # the decode side's suffix extend after a shipped cover (the disagg
    # phases' decode-side extends)
    records.append(measure("paged_decode_attention_suffix_extend",
                           "paged_decode_attention", suffix_case(generator),
                           4, False, {"t_cap": SUFFIX_EXTEND["t_cap"],
                                      "path": "suffix_extend"}))
    return records


def d128_rows(generator, measure) -> list[dict]:
    """The paged kernel at head dim 128 (Llama-3-8B): the decode at the
    llama_8b decoder's shape (16 slots, 8 KV heads, G 4, t_cap 512, P 16:
    its launches are that phase's), the extend (256 rows a KV head, P
    64), int8 pools folded, and a TP-8 rank's decode (one KV head)."""
    records = []
    steps = LLAMA_8B_DECODER["steps_per_sync"]
    records.append(measure(
        "paged_decode_attention_d128", "paged_decode_attention",
        paged_case(generator, 512, steps, head_dim=128), 4, True,
        {"t_cap": 512, "path": "decode_d128"}))
    records.append(measure(
        "paged_decode_attention_d128_extend", "paged_decode_attention",
        extend_case(generator, head_dim=128), 4, False,
        {"t_cap": 768, "path": "extend_d128"}))
    quantized = list(paged_case(generator, 512, steps, head_dim=128))
    quantized[1], quantized[2] = int8_pool(quantized[1]), \
        int8_pool(quantized[2])
    records.append(measure(
        "paged_decode_attention_int8_fold_d128",
        "paged_decode_attention_int8_fold", quantized, 4, True,
        {"t_cap": 512, "path": "decode_d128"}))
    records.append(measure(
        "paged_decode_attention_tp8_d128", "paged_decode_attention",
        paged_case(generator, 512, steps, head_dim=128, num_kv=1), 4, True,
        {"t_cap": 512, "path": "decode_tp8_d128"}))
    return records


def speech_like(rng, seconds: float, sample_rate: int = 16000):
    """A seeded int16 signal with speech-like structure: a few drifting
    harmonics under an amplitude envelope, plus noise."""
    import numpy as np
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    f0 = 110.0 + 60.0 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    voice = sum(np.sin(k * phase) / k for k in range(1, 6))
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t + rng.uniform(0, 6))
    signal = 0.3 * voice * envelope + 0.02 * rng.standard_normal(t.shape)
    return np.clip(signal * 16384.0, -32768, 32767).astype(np.int16)


class plain_flash:
    """Within this block the dispatcher's flash path runs the kernel's
    plain version instead of the kernel: the kernel-vs-plain comparison
    of the encoder features (the port itself never does this)."""

    def __enter__(self):
        from aiko_services_tpu_torch.ops import attention as A
        self._module, self._kernel = A, A.flash_attention
        A.flash_attention = lambda q, k, v, causal=False, scale=None: \
            A.flash_attention_reference(q, k, v, causal=causal, scale=scale)

    def __exit__(self, *exc):
        self._module.flash_attention = self._kernel
        return False


class flash_shapes:
    """Within this block every shape the dispatcher hands the flash
    wrapper is recorded in `seen`; the wrapper itself runs unchanged and
    keeps its own launch count."""

    def __enter__(self):
        from aiko_services_tpu_torch.ops import attention as A
        self._module, self._kernel = A, A.flash_attention
        self.seen = set()

        def recorded(q, k, v, **kwargs):
            self.seen.add(tuple(q.shape))
            return self._kernel(q, k, v, **kwargs)
        A.flash_attention = recorded
        return self

    def __exit__(self, *exc):
        self._module.flash_attention = self._kernel
        return False


def check_flash_shapes(phase: str, seen: set) -> list:
    """The flash kernel ran at the shape its kernels-line row was
    compared and timed at, and at no other."""
    shape = FLASH_SHAPES[FLASH_ROWS[phase]]
    if seen != {shape}:
        raise AssertionError(f"{phase}: flash ran at {sorted(seen)}, its "
                             f"row holds {shape}")
    return list(shape)


def covered_ms(spans) -> float:
    """Milliseconds covered by the union of (name, start us, end us)
    spans."""
    total, reach = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda span: span[1]):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def profile_batch(label: str, submit, scheduler) -> dict:
    """One batch through the scheduler under torch.profiler: host wall
    time, the summed device time of its kernels (one stream, so they do
    not overlap), the device's idle share, and the kernels that take the
    most device time.  Device figures are None when the profiler records
    no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        submit()
        scheduler.drain(force=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_name, launches = {}, 0
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            launches += 1
            by_name[event.name] = by_name.get(event.name, 0.0) + \
                event.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda item: -item[1])[:8]
    return {"batch": label, "wall_s": wall,
            "device_busy_s": busy_ms / 1e3 if launches else None,
            "idle_share": 1.0 - busy_ms / 1e3 / wall if launches else None,
            "device_launches": launches,
            # a kernel's name, not a metric family
            "flash_ms": sum(ms for name, ms in by_name.items()
                            if "flash_attention_kernel" in name),  # graft: disable=lint-metric-drift
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


def host_runtime(device=None, mesh=None):
    """A port ProcessRuntime on its own event engine (virtual clock) and
    in-memory broker, with a ComputeRuntime on `device` (None: the
    card), over `mesh` when given."""
    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    broker = MemoryBroker()

    def transport(on_message, lwt_topic, lwt_payload, lwt_retain):
        return MemoryMessage(on_message=on_message, broker=broker,
                             lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                             lwt_retain=lwt_retain)
    runtime = ProcessRuntime(name="chip_smoke",
                             engine=EventEngine(VirtualClock()),
                             transport_factory=transport).initialize()
    return runtime, ComputeRuntime(runtime, "compute", device=device,
                                   mesh=mesh)


def phase_slice() -> dict:
    """Serve Whisper-small requests through ComputeRuntime +
    PE_WhisperASR; returns the kernel launch counts of that run."""
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch.models.whisper import (
        encode, greedy_decode_from_audio)
    from aiko_services_tpu_torch.ops import attention as A
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram
    from aiko_services_tpu_torch.pipeline import (Pipeline,
                                                  parse_pipeline_definition)

    runtime, compute = host_runtime()
    parameters = {
        "preset": "small", "frontend": "audio", "buckets": [500, 1000, 3000],
        "max_batch": 8, "pad_batch": True, "max_tokens": 24,
        # random weights give near-uniform token distributions, which
        # the hallucination gates would suppress; the smoke checks the
        # decode itself, so the gates are opened
        "logprob_threshold": -1e9, "compression_ratio_threshold": 1e9,
    }
    # two ASR elements (the int16 and mu-law wires) as the heads of one
    # pipeline; requests reach them through submit(), outside a walk
    elements = [{"name": name, "parameters": element_parameters,
                 "input": [{"name": "audio"}],
                 "output": [{"name": "tokens"}, {"name": "text"}],
                 "deploy": {"local": {"class_name": "PE_WhisperASR"}}}
                for name, element_parameters in (
                    ("asr", parameters),
                    ("asr_mulaw", {**parameters, "wire": "mulaw"}))]
    pipeline = Pipeline(runtime, parse_pipeline_definition({
        "version": 0, "name": "p_slice", "runtime": "python",
        "graph": ["(asr)", "(asr_mulaw)"], "elements": elements}))
    start = time.perf_counter()
    asr = pipeline.graph.node("asr").element
    asr_mulaw = pipeline.graph.node("asr_mulaw").element
    asr_scheduler, mulaw_scheduler = asr.scheduler, asr_mulaw.scheduler
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    config = asr.config
    if (config.dim, config.num_heads, config.enc_layers, config.dec_layers,
            config.n_vocab) != (768, 12, 12, 12, 51865):
        raise AssertionError(f"not Whisper-small: {config}")
    if asr.buckets != [500, 1000, 3072]:
        raise AssertionError(f"buckets {asr.buckets} != [500, 1000, 3072]")

    rng = np.random.default_rng(0)
    long_audio = [speech_like(rng, s) for s in (25.0, 27.0, 28.5, 30.0)]
    short_audio = [speech_like(rng, s) for s in (2.6, 3.0, 3.4)]
    mulaw_audio = [speech_like(rng, 3.1)]

    def serve_round():
        results = {}

        def keep(sid, result):
            results[sid] = result
        for i, audio in enumerate(long_audio):
            asr.submit(f"long{i}", keep, audio=audio)
        for i, audio in enumerate(short_audio):
            asr.submit(f"short{i}", keep, audio=audio)
        for i, audio in enumerate(mulaw_audio):
            asr_mulaw.submit(f"mulaw{i}", keep, audio=audio)
        asr_scheduler.drain(force=True)
        mulaw_scheduler.drain(force=True)
        torch.cuda.synchronize()
        return results

    # the main path's run: counts set to 0 just before, read just after
    for name in A.launches:
        A.launches[name] = 0
    dispatch_before = dict(A.dispatch_stats)
    start = time.perf_counter()
    with flash_shapes() as shapes:
        results = serve_round()
    first_round_s = time.perf_counter() - start
    counts = dict(A.launches)
    flash_shape = check_flash_shapes("slice", shapes.seen)
    dispatched = {key: A.dispatch_stats[key] - dispatch_before[key]
                  for key in dispatch_before}

    expected = len(long_audio) + len(short_audio) + len(mulaw_audio)
    if len(results) != expected:
        raise AssertionError(f"{len(results)} answers for {expected} "
                             f"requests")
    for sid, result in results.items():
        if isinstance(result, Exception):
            raise AssertionError(f"request {sid} failed: {result!r}")
        tokens = np.asarray(result["tokens"])
        if tokens.size == 0 or tokens.min() < 0 or \
                tokens.max() >= config.n_vocab:
            raise AssertionError(f"request {sid}: tokens {tokens}")
        if not isinstance(result["text"], str) or \
                not math.isfinite(result["avg_logprob"]):
            raise AssertionError(f"request {sid}: bad result {result}")
    long_batches = -(-len(long_audio) // 8)
    expected_flash = config.enc_layers * long_batches
    if counts["flash_attention"] != expected_flash:
        raise AssertionError(f"flash launches {counts['flash_attention']} "
                             f"!= 12 x {long_batches} long-audio batches")

    # steady batches: the same requests again
    serve_round()
    steady = {}
    for name in ("whisper_asr.asr", "whisper_asr.asr_mulaw"):
        for bucket, seconds in compute.programs[name].recent_service:
            steady.setdefault(f"{name}:{bucket}", []).append(seconds)
    first_calls = {f"{name}:{bucket}": seconds
                   for name in ("whisper_asr.asr", "whisper_asr.asr_mulaw")
                   for bucket, seconds in
                   compute.programs[name].first_call_times.items()}

    # where a steady batch's time goes, per bucket
    profiles = [
        profile_batch("asr:3072", lambda: [
            asr.submit(f"p{i}", lambda *_: None, audio=audio)
            for i, audio in enumerate(long_audio)], asr_scheduler),
        profile_batch("asr:500", lambda: [
            asr.submit(f"p{i}", lambda *_: None, audio=audio)
            for i, audio in enumerate(short_audio)], asr_scheduler)]

    # one long request's encoder features: kernel against plain version
    pcm = np.zeros((1, 3072 * 160), np.int16)
    pcm[0, :long_audio[0].shape[0]] = long_audio[0]
    bucket_config = dataclasses.replace(config, n_audio_ctx=1536)
    with torch.inference_mode():
        mel = log_mel_spectrogram(
            torch.from_numpy(pcm).cuda().float() / 32768.0).to(config.dtype)
        with_kernel = encode(asr.params, bucket_config, mel)
        with plain_flash():
            with_plain = encode(asr.params, bucket_config, mel)
        torch.cuda.synchronize()
        diff = with_kernel.float() - with_plain.float()
        rel_l2 = (diff.norm() / with_plain.float().norm()).item()
        max_abs = diff.abs().max().item()
        if with_kernel.shape != (1, 1536, 768) or \
                not torch.isfinite(with_kernel).all() or \
                not rel_l2 <= ENCODER_REL_L2:
            raise AssertionError(f"encoder kernel vs plain: rel L2 {rel_l2} "
                                 f"(limit {ENCODER_REL_L2}), max abs "
                                 f"{max_abs}, shape "
                                 f"{tuple(with_kernel.shape)}")
        kwargs = dict(max_tokens=24, suppress_timestamps=True)
        tokens_kernel, _, _ = greedy_decode_from_audio(
            asr.params, bucket_config, with_kernel, **kwargs)
        tokens_plain, _, _ = greedy_decode_from_audio(
            asr.params, bucket_config, with_plain, **kwargs)
        agreement = (tokens_kernel == tokens_plain).float().mean().item()

    emit({"phase": "slice", "requests": len(results),
          "setup_s": setup_s, "first_round_s": first_round_s,
          "first_call_s": first_calls,
          "steady_batch_s": {key: statistics.median(values)
                             for key, values in steady.items()},
          "launches": counts, "dispatch": dispatched,
          "flash_launches_expected": expected_flash,
          "flash_shape": flash_shape,
          "encoder_rel_l2": rel_l2, "encoder_max_abs": max_abs,
          "encoder_rel_l2_limit": ENCODER_REL_L2,
          "token_agreement_kernel_vs_plain": agreement,
          "sample_tokens": {sid: np.asarray(r["tokens"])[:6].tolist()
                            for sid, r in sorted(results.items())[:2]},
          "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    for record in profiles:
        emit({"phase": "profile", **record})
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    return counts


def phase_surface(smi: str) -> int:
    """models.greedy_decode, the package's re-export, on Whisper-small at
    bucket 3072 (3b); returns its flash launches."""
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch import models, resolve_device
    from aiko_services_tpu_torch.models.whisper import greedy_decode_scored
    from aiko_services_tpu_torch.observe.metrics import Histogram
    from aiko_services_tpu_torch.observe.tracing import Tracer, new_trace
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram

    config = dataclasses.replace(
        models.WHISPER_PRESETS["small"], n_audio_ctx=SURFACE["frames"] // 2,
        n_text_ctx=SURFACE["max_tokens"] + 8, dtype=torch.bfloat16)
    if (config.dim, config.num_heads, config.enc_layers, config.dec_layers,
            config.n_vocab) != WHISPER_SMALL:
        raise AssertionError(f"surface: not Whisper-small: {config}")
    device = resolve_device(None)
    params = models.whisper_init(
        torch.Generator(device=device).manual_seed(0), config)
    rng = np.random.default_rng(SURFACE["seed"])
    pcm = np.zeros((len(SURFACE["seconds"]), SURFACE["frames"] * 160),
                   np.int16)
    for row, seconds in enumerate(SURFACE["seconds"]):
        audio = speech_like(rng, seconds)
        pcm[row, :audio.shape[0]] = audio
    with torch.inference_mode():
        mel = log_mel_spectrogram(torch.from_numpy(pcm).to(device).float()
                                  / 32768.0).to(config.dtype)
    kwargs = {"max_tokens": SURFACE["max_tokens"],
              "suppress_timestamps": True}
    tracer = Tracer(enabled=True)
    histogram = Histogram("surface_greedy_decode_seconds", {})
    context = new_trace()
    torch.cuda.synchronize()
    # the main path's run: counts set to 0 just before, read just after
    zero_attention_counts()
    with flash_shapes() as shapes:
        with tracer.span("surface.greedy_decode", context=context,
                         cat="surface"):
            tokens, lengths = models.greedy_decode(params, config, mel,
                                                   **kwargs)
            torch.cuda.synchronize()
    counts = attention_counts()
    flash_shape = check_flash_shapes("surface", shapes.seen)
    # steady calls, for the histogram (their launches are not counted)
    for _ in range(SURFACE["timed_calls"] - 1):
        with tracer.span("surface.greedy_decode", context=context,
                         cat="surface"):
            models.greedy_decode(params, config, mel, **kwargs)
            torch.cuda.synchronize()
    spans = [span for span in tracer.spans
             if span.name == "surface.greedy_decode"]
    for span in spans:
        histogram.observe(span.dur)
    ref_tokens, ref_lengths, _ = greedy_decode_scored(params, config, mel,
                                                      **kwargs)
    equal = torch.equal(tokens, ref_tokens) and \
        torch.equal(lengths, ref_lengths)
    batch = len(SURFACE["seconds"])
    shaped = tuple(tokens.shape) == (batch, SURFACE["max_tokens"]) and \
        tuple(lengths.shape) == (batch,) and \
        int(tokens.min()) >= 0 and int(tokens.max()) < config.n_vocab and \
        0 <= int(lengths.min()) and \
        int(lengths.max()) <= SURFACE["max_tokens"]
    child = spans[0].parent_id == context.span_id and \
        spans[0].trace_id == context.trace_id
    emit({"phase": "surface", "card": smi, "batch": batch,
          "mel_shape": list(mel.shape), "launches": counts,
          "flash_launches_expected": SURFACE_FLASH,
          "flash_shape": flash_shape, "tokens_equal_scored": equal,
          "span_s": spans[0].dur,
          "span_child_of_context": child,
          "timed_calls": len(spans),
          "histogram_p50_s": histogram.quantile(0.5),
          "histogram_max_s": histogram.quantile(1.0),
          "sample_tokens": tokens[0, :6].tolist(),
          "lengths": lengths.tolist()})
    if counts["flash_attention"] != SURFACE_FLASH or not equal or \
            not shaped or not child or \
            sum(counts.values()) != counts["flash_attention"]:
        raise AssertionError(
            f"surface: launches {counts} (want {SURFACE_FLASH} flash), "
            f"tokens equal to greedy_decode_scored's {equal}, shapes "
            f"{shaped}, span a child of its context {child}")
    del params
    torch.cuda.empty_cache()
    return counts["flash_attention"]


def phase_pipeline(mesh=None, phase: str = "pipeline") -> tuple:
    """examples/speech/pipeline_transcription.json on the port, driven on
    a virtual clock (PE_MicrophoneSim → PE_AudioFraming → PE_LogMel on the
    card → PE_WhisperASR, Whisper-small in bf16 → PE_Synthesize →
    PE_Speaker), its ComputeRuntime over `mesh` when given; returns (the
    kernel launch counts of that run, each frame's tokens by stream and
    frame)."""
    import numpy as np

    from aiko_services_tpu_torch.ops import attention as A
    from aiko_services_tpu_torch.pipeline import (Pipeline,
                                                  load_pipeline_definition)

    runtime, compute = host_runtime(mesh=mesh)
    engine = runtime.event
    definition = load_pipeline_definition(
        "examples/speech/pipeline_transcription.json")
    # only the hallucination gates change: random weights give
    # near-uniform logprobs
    definition.parameters.update({
        "PE_WhisperASR.logprob_threshold": -1e9,
        "PE_WhisperASR.compression_ratio_threshold": 1e9})
    pipeline = Pipeline(runtime, definition, stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    # 8 short streams with the example's parameters (1 s chunks, window
    # 3: frames of 1-3 s, bucket 500) and 4 long ones (10 s chunks:
    # frames of 10, 20 and 30 s, buckets 1000 and 3072)
    streams = {f"short{i}": {"PE_MicrophoneSim.limit": 4,
                             "PE_MicrophoneSim.frequency": 220.0 + 40 * i}
               for i in range(8)}
    streams.update({f"long{i}": {"PE_MicrophoneSim.chunk_seconds": 10.0,
                                 "PE_AudioFraming.window_count": 3,
                                 "PE_MicrophoneSim.limit": 3,
                                 "PE_MicrophoneSim.frequency": 180.0 + 70 * i}
                    for i in range(4)})
    expected = 8 * 4 + 4 * 3
    start = time.perf_counter()
    # the main path's run: counts set to 0 just before, read just after
    for name in A.launches:
        A.launches[name] = 0
    for stream_id, parameters in streams.items():
        pipeline.create_stream(stream_id, parameters=parameters,
                               lease_time=0)
    asr = pipeline.graph.node("PE_WhisperASR").element
    with flash_shapes() as shapes:
        while len(done) < expected and engine.clock.now() < 60.0:
            while engine.step():
                pass
            engine.clock.advance(0.01)
        torch.cuda.synchronize()
    counts = dict(A.launches)
    wall_s = time.perf_counter() - start
    virtual_s = engine.clock.now()

    config = asr.config
    if (config.dim, config.num_heads, config.enc_layers, config.dec_layers,
            config.n_vocab) != WHISPER_SMALL or \
            asr.buckets != [500, 1000, 3072]:
        raise AssertionError(f"not Whisper-small in buckets [500, 1000, "
                             f"3072]: {config}, {asr.buckets}")
    failed = pipeline.recovery_stats["frames_failed"]
    if len(done) != expected or failed:
        raise AssertionError(f"{len(done)} of {expected} frames completed, "
                             f"{failed} failed")
    scheduler = asr.scheduler
    frames_per_bucket = {}
    for frame in done:
        tokens = np.asarray(frame.swag["tokens"])
        if tokens.size == 0 or tokens.min() < 0 or \
                tokens.max() >= config.n_vocab or \
                not isinstance(frame.swag["text"], str) or \
                "time_PE_WhisperASR" not in frame.metrics:
            raise AssertionError(f"frame {frame.stream_id}:{frame.frame_id}"
                                 f": tokens {tokens}, swag "
                                 f"{sorted(frame.swag)}, metrics "
                                 f"{sorted(frame.metrics)}")
        bucket = scheduler.buckets.bucket_for(frame.swag["mel"].shape[0])
        frames_per_bucket[bucket] = frames_per_bucket.get(bucket, 0) + 1
    speaker = {sid: stream.variables.get("speaker.audio")
               for sid, stream in pipeline.streams.items()}
    if sorted(sid for sid, audio in speaker.items()
              if audio is not None and audio.size) != sorted(streams):
        heard = [sid for sid, audio in speaker.items() if audio is not None]
        raise AssertionError(f"PE_Speaker collected audio for {heard}")
    program = compute.programs["whisper_asr.PE_WhisperASR"]
    batches_per_bucket = {bucket: 1 for bucket in program.first_call_times}
    steady = {}
    for bucket, seconds in program.recent_service:
        batches_per_bucket[bucket] += 1
        steady.setdefault(bucket, []).append(seconds)
    long_batches = batches_per_bucket.get(3072, 0)
    expected_flash = config.enc_layers * long_batches
    if not long_batches or counts["flash_attention"] != expected_flash:
        raise AssertionError(f"flash launches {counts['flash_attention']} "
                             f"!= 12 x {long_batches} bucket-3072 batches")
    flash_shape = check_flash_shapes(phase, shapes.seen)
    tokens = {f"{frame.stream_id}/{frame.frame_id}":
              np.asarray(frame.swag["tokens"]).tolist() for frame in done}
    placed = {"agreed": scheduler.agreed,
              "q_columns": int(asr.params["enc_blocks"][0]["attn"]["q"]
                               ["w"].shape[1]),
              "vocab_rows": int(asr.params["tok_embed"]["table"].shape[0])}
    mean_batch = scheduler.mean_batch_size()
    if not mean_batch > 1:
        raise AssertionError(f"mean batch size {mean_batch}: no coalescing")
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    # no microphone tick and no stream lease outlives its stream; the
    # rest (the compute runtime's timers) goes with the runtime
    stream_timers = [handler for handler in engine.live_timer_handlers()
                     if "start_stream" in getattr(handler, "__qualname__", "")
                     or type(getattr(handler, "__self__", None)).__name__
                     == "Lease"]
    share = dict(compute.ec_producer.share)
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    live_timers = engine.live_timer_handlers()
    if stream_timers or live_timers:
        raise AssertionError(f"timers left after teardown: stream "
                             f"{stream_timers}, all {live_timers}")
    emit({"phase": phase, "streams": len(streams), "frames": len(done),
          "frames_failed": failed, "placed": placed,
          "frames_per_bucket": frames_per_bucket,
          "batches_per_bucket": batches_per_bucket,
          "mean_batch_size": mean_batch, "launches": counts,
          "flash_launches_expected": expected_flash,
          "flash_shape": flash_shape,
          "virtual_s": virtual_s, "wall_s": wall_s,
          "first_call_s": share.get("first_call", {}),
          "steady_batch_s": {bucket: statistics.median(values)
                             for bucket, values in steady.items()},
          "live_timers_after_teardown": len(live_timers),
          "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return counts, tokens


def phase_asr_mesh(reference_counts: dict, reference_tokens: dict) -> dict:
    """The pipeline phase's drive with its ComputeRuntime over a one-rank
    NCCL mesh {model: 1}: PE_WhisperASR places Whisper-small by
    whisper_axes through the runtime (every head, the whole FFN and
    vocabulary on one rank) and runs its programs with the runtime's
    sharding_mesh, its batches cut by the runtime's agreement (at one
    rank, no gather).  Its flash launches and every frame's tokens must
    equal the pipeline phase's.  Returns the run's launch counts."""
    import torch.distributed as dist

    from aiko_services_tpu_torch.parallel import create_mesh

    mesh = create_mesh({"model": 1})
    if dist.get_backend() != "nccl" or mesh.size() != 1 or \
            mesh.device_type != "cuda":
        raise AssertionError(f"mesh {mesh} on {dist.get_backend()}")
    counts, tokens = phase_pipeline(mesh=mesh, phase="asr_mesh")
    if counts != reference_counts or tokens != reference_tokens:
        differing = sorted(key for key in set(tokens) | set(
            reference_tokens) if tokens.get(key) !=
            reference_tokens.get(key))
        raise AssertionError(
            f"asr_mesh: launches {counts} against the pipeline's "
            f"{reference_counts}, frames differing {differing[:8]}")
    emit({"phase": "asr_mesh_check", "mesh": {"model": 1},
          "launches_equal_pipeline": True, "tokens_equal_pipeline": True,
          "frames": len(tokens)})
    return counts


def profile_round(decoder, label: str = "llama decode") -> dict:
    """One pump round under torch.profiler: host wall time, the device
    time its kernels cover, the idle share, the paged kernel's share and
    calls, the costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aiko_services_tpu_torch.ops import paged_attention as P

    torch.cuda.synchronize()
    calls_before = sum(P.launches.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        decoder.pump()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    paged_calls = sum(P.launches.values()) - calls_before
    by_name, spans = {}, []
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            spans.append((event.name, event.time_range.start,
                          event.time_range.end))
            by_name[event.name] = by_name.get(event.name, 0.0) + \
                event.time_range.elapsed_us() / 1e3
    # the split path's merge kernel starts before the split kernel ends
    # (programmatic dependent launch): busy time is the union of the
    # kernels' spans, not their sum
    busy_ms = covered_ms(spans)
    top = sorted(by_name.items(), key=lambda item: -item[1])[:8]
    # the paged wrapper's kernels: the split path (split + merge) and the
    # tensor-core path, [device ms (union of spans), calls]
    paged = {path: [covered_ms([s for s in spans
                                if any(k in s[0] for k in kernels)]),
                    sum(1 for s in spans if kernels[0] in s[0])]
             for path, kernels in (
                 ("split", ("paged_split_kernel", "paged_combine_kernel")),
                 ("tensor_cores", ("paged_mma_kernel",)))}
    return {"round": label, "wall_s": wall,
            "device_busy_s": busy_ms / 1e3 if spans else None,
            "idle_share": 1.0 - busy_ms / 1e3 / wall if spans else None,
            "device_launches": len(spans),
            "paged_kernel_ms": sum(ms for ms, _ in paged.values()),
            "paged_ms_calls": paged, "paged_calls": paged_calls,
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


def llama_traffic(rng, vocab: int) -> list:
    """24 requests (id, prompt, max_new): 16–128 seeded prompt tokens and
    24–64 new tokens each, the first a 128-token prompt asking 320 new
    tokens, whose context takes t_cap from 256 to 512."""
    requests = [("long", rng.integers(0, vocab, 128).tolist(), 320)]
    for i in range(23):
        prompt = rng.integers(0, vocab, int(rng.integers(16, 129)))
        requests.append((f"r{i}", prompt.tolist(),
                         int(rng.integers(24, 65))))
    return requests


def phase_llama() -> int:
    """Serve Llama-1B requests through the paged ContinuousDecoder;
    returns the paged kernel's launches in that run."""
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = dataclasses.replace(LLAMA_PRESETS["1b"], dtype=torch.bfloat16,
                                 max_seq_len=1024)
    if (config.dim, config.num_heads, config.num_kv_heads, config.num_layers,
            config.ffn_dim, config.vocab) != (2048, 32, 8, 16, 8192, 128256):
        raise AssertionError(f"not the 1b preset: {config}")
    start = time.perf_counter()
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    decoder = ContinuousDecoder(params, config, **LLAMA_DECODER)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start

    requests = llama_traffic(np.random.default_rng(0), config.vocab)
    budgets = {rid: new for rid, _, new in requests}
    done = {}

    def keep(request_id, tokens):
        done[request_id] = list(tokens)

    # the main path's run: counts set to 0 just before, read just after
    P.launches["paged_decode_attention"] = 0
    start = time.perf_counter()
    for rid, prompt, new in requests[:16]:
        decoder.submit(rid, prompt, new, keep)
    round_s, t_caps = [], []
    while True:
        round_start = time.perf_counter()
        decoder.pump()
        round_s.append(time.perf_counter() - round_start)
        t_caps.append(decoder._cache_t)
        if len(round_s) == 1:
            for rid, prompt, new in requests[16:]:
                decoder.submit(rid, prompt, new, keep)
        if decoder.idle:
            break
        if len(round_s) > 500:
            raise AssertionError("the decoder did not drain in 500 rounds")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = P.launches["paged_decode_attention"]
    stats = dict(decoder.stats)

    if sorted(done) != sorted(budgets):
        raise AssertionError(f"{len(done)} of {len(budgets)} completed")
    for rid, tokens in done.items():
        if len(tokens) != budgets[rid] or \
                not all(0 <= t < config.vocab for t in tokens):
            raise AssertionError(f"request {rid}: {len(tokens)} tokens of "
                                 f"{budgets[rid]}")
    if decoder.pool.used_blocks() != 0:
        raise AssertionError(f"{decoder.pool.used_blocks()} pool blocks "
                             f"still owned after the run")
    if launches != config.num_layers * stats["steps"]:
        raise AssertionError(f"paged kernel launches {launches} != "
                             f"{config.num_layers} x {stats['steps']} steps")
    if max(t_caps) != 512:
        raise AssertionError(f"t_cap reached {max(t_caps)}, not 512")
    generated = sum(len(tokens) for tokens in done.values())
    memory_gb = torch.cuda.max_memory_allocated() / 1e9

    # one steady decode round of 16 fresh requests under the profiler
    rng = np.random.default_rng(1)
    for i in range(16):
        decoder.submit(f"p{i}", rng.integers(0, config.vocab, 64).tolist(),
                       40, lambda *_: None)
    decoder.pump()                 # admits
    decoder.pump()                 # first decode round
    profile = profile_round(decoder)
    while not decoder.idle:
        decoder.pump()
    if decoder.pool.used_blocks() != 0:
        raise AssertionError("pool blocks still owned after the profile")

    emit({"phase": "llama", "requests": len(done), "tokens": generated,
          "setup_s": setup_s, "wall_s": wall,
          "tokens_per_s": generated / wall, "rounds": len(round_s),
          "first_round_s": round_s[0],
          "steady_round_s": statistics.median(round_s[2:]),
          "round_s": round_s, "t_cap": t_caps, "steps": stats["steps"],
          "paged_launches": launches,
          "paged_launches_expected": config.num_layers * stats["steps"],
          "useful_steps": stats["useful_steps"],
          "wasted_steps": stats["wasted_steps"],
          "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
          "pool_blocks": decoder.pool.num_blocks - 1,
          "kv_cache_bytes": decoder.kv_cache_bytes(),
          "max_memory_gb": memory_gb,
          "sample_tokens": {rid: done[rid][:6] for rid in ("long", "r0")}})
    emit({"phase": "profile", **profile})
    return launches


def phase_llama_f32() -> dict:
    """Full width at 2 layers in f32: the paged decoder's greedy tokens
    against llama_greedy_decode (dense cache, plain attention).  A
    mismatch whose reference top-2 logit gap is under 1e-4 is printed as
    a tie; any other fails."""
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                      llama_init)
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    # f32 products in full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = dataclasses.replace(LLAMA_PRESETS["1b"], num_layers=2,
                                 dtype=torch.float32, max_seq_len=1024)
    params = llama_init(torch.Generator(device="cuda").manual_seed(1),
                        config)
    decoder = ContinuousDecoder(params, config, **{**LLAMA_DECODER,
                                                   "max_slots": 4})
    rng = np.random.default_rng(2)
    prompts = {f"f{n}": rng.integers(0, config.vocab, n).tolist()
               for n in (20, 57, 100, 128)}
    record = {"phase": "llama_f32",
              **paged_against_greedy(params, config, decoder, prompts, 24)}
    emit(record)
    return record


def paged_against_greedy(params, config, decoder, prompts: dict,
                         max_new: int) -> dict:
    """Serve `prompts` through `decoder` and hold each request's tokens
    against llama_greedy_decode on the same params (dense cache, plain
    attention), f32: identical, or a tie (the reference's top-2 logit
    gap under 1e-4 at the first mismatch); any other mismatch raises."""
    from aiko_services_tpu_torch.models.llama import (llama_forward,
                                                      llama_greedy_decode)
    done = {}
    for rid, prompt in prompts.items():
        decoder.submit(rid, prompt, max_new,
                       lambda r, t: done.update({r: list(t)}))
    while not decoder.idle:
        decoder.pump()
    ties, identical = [], 0
    with torch.inference_mode():
        for rid, prompt in prompts.items():
            ref = llama_greedy_decode(
                params, config, torch.tensor([prompt], device="cuda"),
                max_tokens=max_new)[0].tolist()
            got = done[rid]
            if got == ref:
                identical += 1
                continue
            i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
            logits = llama_forward(params, config, torch.tensor(
                [prompt + ref[:i]], device="cuda"))[0, -1]
            top2 = torch.topk(logits, 2).values
            gap = (top2[0] - top2[1]).item()
            if gap >= 1e-4:
                raise AssertionError(
                    f"f32 request {rid}: paged token {got[i]} != dense "
                    f"{ref[i]} at step {i}, top-2 gap {gap}")
            ties.append({"request": rid, "step": i, "gap": gap})
    return {"requests": len(prompts), "identical": identical, "ties": ties,
            "pool_blocks_used": decoder.pool.used_blocks()}


def int8_traffic(rng, vocab: int) -> list:
    """24 requests (id, prompt, max_new) of 32 new tokens: 16 with 65-640
    prompt tokens (chunked; the first exactly 640) and 8 with 16-64
    (bucketed), in the order they are submitted: 10 chunked and 6
    bucketed first, the other 8 after the first round."""
    chunked = [640] + [int(n) for n in rng.integers(65, 641, 15)]
    short = [int(n) for n in rng.integers(16, 65, 8)]
    lengths = chunked[:10] + short[:6] + chunked[10:] + short[6:]
    return [(f"{'c' if n > 64 else 's'}{i}", rng.integers(0, vocab,
                                                          n).tolist(), 32)
            for i, n in enumerate(lengths)]


def count_extends(decoder) -> list:
    """Count the decoder's chunk-extend dispatches (one launch of the
    dequantizing kernel per layer each) by wrapping its _extend_group;
    returns the one-element counter."""
    dispatches = [0]
    extend_group = decoder._extend_group

    def counted(*args, **kwargs):
        dispatches[0] += 1
        return extend_group(*args, **kwargs)

    decoder._extend_group = counted
    return dispatches


def phase_llama_int8_chunked() -> dict:
    """Serve Llama-1B requests through the paged ContinuousDecoder with
    int8 KV pools and chunked prefill; returns the paged kernel's
    launches per variant in that run."""
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = dataclasses.replace(LLAMA_PRESETS["1b"], dtype=torch.bfloat16,
                                 max_seq_len=1024)
    if (config.dim, config.num_heads, config.num_kv_heads, config.num_layers,
            config.ffn_dim, config.vocab) != (2048, 32, 8, 16, 8192, 128256):
        raise AssertionError(f"not the 1b preset: {config}")
    start = time.perf_counter()
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    decoder = ContinuousDecoder(params, config, **LLAMA_INT8_DECODER)
    dispatches = count_extends(decoder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - start

    requests = int8_traffic(np.random.default_rng(3), config.vocab)
    budgets = {rid: new for rid, _, new in requests}
    done = {}

    def keep(request_id, tokens):
        done[request_id] = list(tokens)

    # the main path's run: counts set to 0 just before, read just after.
    # torch's sync debug mode warns at every call that synchronizes the
    # stream (a copy from pageable memory, .item(), nonzero); the round's
    # own wait, on the event behind its device-to-host copy, is not one
    # of them, so the decoder must make none
    for name in P.launches:
        P.launches[name] = 0
    start = time.perf_counter()
    for rid, prompt, new in requests[:16]:
        decoder.submit(rid, prompt, new, keep)
    round_s, t_caps = [], []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            while True:
                round_start = time.perf_counter()
                decoder.pump()
                round_s.append(time.perf_counter() - round_start)
                t_caps.append(decoder._cache_t)
                if len(round_s) == 1:
                    for rid, prompt, new in requests[16:]:
                        decoder.submit(rid, prompt, new, keep)
                if decoder.idle:
                    break
                if len(round_s) > 500:
                    raise AssertionError(
                        "the decoder did not drain in 500 rounds")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    syncs = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message))
    if syncs:
        raise AssertionError(f"the decoder synchronized the stream beyond "
                             f"its one wait a round: {dict(syncs)}")
    launches = dict(P.launches)
    extends = dispatches[0]
    stats = dict(decoder.stats)

    if sorted(done) != sorted(budgets):
        raise AssertionError(f"{len(done)} of {len(budgets)} completed")
    for rid, tokens in done.items():
        if len(tokens) != budgets[rid] or \
                not all(0 <= t < config.vocab for t in tokens):
            raise AssertionError(f"request {rid}: {len(tokens)} tokens of "
                                 f"{budgets[rid]}")
    if decoder.pool.used_blocks() != 0:
        raise AssertionError(f"{decoder.pool.used_blocks()} pool blocks "
                             f"still owned after the run")
    expected = {"paged_decode_attention": 0,
                "paged_decode_attention_int8_fold":
                    config.num_layers * stats["steps"],
                "paged_decode_attention_int8_dequant":
                    config.num_layers * extends}
    if launches != expected or not extends:
        raise AssertionError(f"paged kernel launches {launches} != "
                             f"{expected} ({stats['steps']} decode steps, "
                             f"{extends} extend dispatches)")
    if max(t_caps) != 768:
        raise AssertionError(f"t_cap reached {max(t_caps)}, not 768")
    generated = sum(len(tokens) for tokens in done.values())
    memory_gb = torch.cuda.max_memory_allocated() / 1e9

    # one steady round under the profiler: 12 slots decoding, 4 long
    # prompts mid-prefill (one extend of width 4)
    rng = np.random.default_rng(4)
    for i in range(16):
        decoder.submit(f"p{i}", rng.integers(
            0, config.vocab, 300 if i < 4 else 64).tolist(), 40,
            lambda *_: None)
    decoder.pump()                 # admits, first chunks
    decoder.pump()                 # first decode round, second chunks
    profile = profile_round(decoder, "llama int8 decode + extend")
    while not decoder.idle:
        decoder.pump()
    if decoder.pool.used_blocks() != 0:
        raise AssertionError("pool blocks still owned after the profile")

    emit({"phase": "llama_int8_chunked", "requests": len(done),
          "tokens": generated, "setup_s": setup_s, "wall_s": wall,
          "tokens_per_s": generated / wall, "rounds": len(round_s),
          "first_round_s": round_s[0],
          "steady_round_s": statistics.median(round_s[2:]),
          "round_s": round_s, "t_cap": t_caps, "steps": stats["steps"],
          "extend_dispatches": extends, "launches": launches,
          "launches_expected": expected,
          "stream_syncs": sum(syncs.values()),
          "prefill_chunks": stats["prefill_chunks"],
          "chunk_admits": stats["chunk_admits"],
          "prefills": stats["prefills"],
          "round_prefill_tokens_max": stats["round_prefill_tokens_max"],
          "useful_steps": stats["useful_steps"],
          "wasted_steps": stats["wasted_steps"],
          "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
          "pool_blocks": decoder.pool.num_blocks - 1,
          "kv_cache_bytes": decoder.kv_cache_bytes(),
          "max_memory_gb": memory_gb,
          "sample_tokens": {rid: done[rid][:6] for rid in ("c0", "s10")}})
    emit({"phase": "profile", **profile})
    return launches


class LogitGaps:
    """Records, per slot, the top-1 logit and the top-2 gap behind every
    token a decoder emits (first tokens from admits and extends, then the
    decode steps'), by wrapping layers.linear_logits, the decoder's step
    and its admit and extend programs (the paged or the dense ones, as
    the decoder's store).  by_slot is that request's list while each slot
    serves one request; with slots reused, by_request finds each
    request's rows by its tokens among the slots' runs (a run starts at
    each first token)."""

    def __init__(self, decoder, router: bool = False):
        from aiko_services_tpu_torch import serving
        from aiko_services_tpu_torch.models import layers, moe
        self.by_slot = {slot: [] for slot in range(decoder.max_slots)}
        # with `router` (an MoE decoder): per slot, the smallest router
        # top-k boundary gap (p_k - p_k+1 over every row of every MoE
        # call) of the program that emitted each token
        self.router_by_slot = {slot: [] for slot in range(decoder.max_slots)}
        self._router_gaps = []
        # per slot, one list a request: [top-1, gap, token] per emit
        self._runs = {slot: [] for slot in range(decoder.max_slots)}
        self._calls = []
        self._names = ("_paged_admit", "_paged_extend") if decoder.paged \
            else ("_dense_admit", "_dense_extend")
        self._layers, self._serving, self._moe = layers, serving, moe
        self._saved = (layers.linear_logits,
                       *(getattr(serving, name) for name in self._names),
                       moe.moe_forward)
        linear_logits, admit, extend, moe_forward = self._saved

        def recording_moe(params, config, x, mesh=None):
            logits = torch.matmul(x.reshape(-1, x.shape[-1]).float(),
                                  params["router"]["w"].float())
            probs = torch.sort(torch.softmax(logits, dim=-1), dim=-1,
                               descending=True).values
            self._router_gaps.append(
                (probs[:, config.top_k - 1] - probs[:, config.top_k]).min())
            return moe_forward(params, config, x, mesh=mesh)

        def recording_logits(params, x, mesh=None):
            logits = linear_logits(params, x, mesh)
            top = torch.topk(logits.reshape(-1, logits.shape[-1]).float(),
                             2)
            values = top.values           # token ids exact in f32 < 2^24
            columns = [values[:, 0], values[:, 0] - values[:, 1],
                       top.indices[:, 0].float()]
            if router:
                gap = torch.stack(self._router_gaps).min() \
                    if self._router_gaps else torch.tensor(float("inf"))
                self._router_gaps.clear()
                columns.append(torch.full_like(values[:, 0],
                                               float(gap)))
            self._calls.append(torch.stack(columns, dim=1).cpu())
            return logits

        def first_tokens(rows, slots, emits):
            for j in torch.nonzero(emits.cpu()).flatten().tolist():
                self.by_slot[int(slots[j])].append(rows[j, :2].tolist())
                self._runs[int(slots[j])].append([rows[j, :3].tolist()])
                if router:
                    self.router_by_slot[int(slots[j])].append(
                        float(rows[j, 3]))

        # (params, config, k, v, tokens, lengths, context, rows..., slots,
        # valid[, finish], ...): slots at 9, valid at 10, finish at 11
        def recording_admit(*args, **kwargs):
            firsts = admit(*args, **kwargs)
            first_tokens(self._calls[-1], args[9].cpu(), args[10])
            return firsts

        def recording_extend(*args, **kwargs):
            firsts = extend(*args, **kwargs)
            first_tokens(self._calls[-1], args[9].cpu(),
                         args[10] & args[11])
            return firsts

        step = decoder._step

        def recording_step(*args, **kwargs):
            before = len(self._calls)
            out = step(*args, **kwargs)
            for k, active in enumerate(out[1].cpu()):
                rows = self._calls[before + k]
                for slot in torch.nonzero(active).flatten().tolist():
                    self.by_slot[slot].append(rows[slot, :2].tolist())
                    self._runs[slot][-1].append(rows[slot, :3].tolist())
                    if router:
                        self.router_by_slot[slot].append(
                            float(rows[slot, 3]))
            return out

        layers.linear_logits = recording_logits
        setattr(serving, self._names[0], recording_admit)
        setattr(serving, self._names[1], recording_extend)
        decoder._step = recording_step
        if router:
            moe.moe_forward = recording_moe

    def close(self) -> None:
        self._layers.linear_logits = self._saved[0]
        for name, saved in zip(self._names, self._saved[1:3]):
            setattr(self._serving, name, saved)
        self._moe.moe_forward = self._saved[3]

    def by_request(self, done: dict) -> dict:
        """[top-1 logit, top-2 gap] per emitted token of each request in
        `done` (its tokens by request id): the run whose tokens are the
        request's."""
        runs = [run for slot_runs in self._runs.values() for run in slot_runs]
        found = {}
        for rid, tokens in done.items():
            run = next((run for run in runs if len(run) >= len(tokens) and
                        [int(row[2]) for row in run[:len(tokens)]] ==
                        tokens), None)
            if run is None:
                raise AssertionError(f"no recorded run emitted request "
                                     f"{rid}'s tokens")
            found[rid] = [row[:2] for row in run[:len(tokens)]]
        return found


def serve_with_gaps(params, config, device, prompts, max_new,
                    paged: bool = True) -> tuple:
    """(tokens by request, [top-1 logit, top-2 gap] per emitted token by
    request) of the int8 chunked decoder at 4 slots (paged, or the dense
    slot cache)."""
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    decoder = ContinuousDecoder(params, config, device=device, **{
        **LLAMA_INT8_DECODER, "max_slots": len(prompts),
        "paged_kv": paged})
    gaps = LogitGaps(decoder)
    done = {}
    try:
        for rid, prompt in prompts.items():
            decoder.submit(rid, prompt, max_new,
                           lambda r, t: done.update({r: list(t)}))
        requests = list(decoder._pending)
        while not decoder.idle:
            decoder.pump()
    finally:
        gaps.close()
    if paged and decoder.pool.used_blocks() != 0:
        raise AssertionError("int8 f32 run left pool blocks owned")
    return done, {r.request_id: gaps.by_slot[r.slot] for r in requests}


def phase_llama_int8_f32() -> dict:
    """Full width at 2 layers in f32, int8 KV pools and chunked prefill:
    the decoder on the card against the same port decoder on the CPU (the
    kernels' plain versions) with the same weights.  A first mismatch
    whose CPU top-2 logit gap is under INT8_TIE_GAP is printed as a tie;
    any other fails."""
    record = {"phase": "llama_int8_f32", **int8_card_against_cpu(True)}
    emit(record)
    return record


def int8_card_against_cpu(paged: bool) -> dict:
    """phase_llama_int8_f32's check on the paged decoder or the dense
    slot cache: the int8 chunked decoder at 2 layers in f32 on the card
    against the same decoder on the CPU, under INT8_TIE_GAP."""
    import copy
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init

    # f32 products in full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = dataclasses.replace(LLAMA_PRESETS["1b"], num_layers=2,
                                 dtype=torch.float32, max_seq_len=1024)
    params = llama_init(torch.Generator(device="cuda").manual_seed(2),
                        config)
    cpu_params = copy.deepcopy(params).cpu()
    rng = np.random.default_rng(5)
    prompts = {f"i{n}": rng.integers(0, config.vocab, n).tolist()
               for n in (40, 100, 200, 300)}
    max_new = 16
    start = time.perf_counter()
    got, gpu_gaps = serve_with_gaps(params, config, "cuda", prompts,
                                    max_new, paged)
    card_s = time.perf_counter() - start
    start = time.perf_counter()
    with torch.inference_mode():
        ref, cpu_gaps = serve_with_gaps(cpu_params, config, "cpu", prompts,
                                        max_new, paged)
    cpu_s = time.perf_counter() - start
    ties, identical, drift = [], 0, 0.0
    for rid in prompts:
        if len(got[rid]) != max_new or len(ref[rid]) != max_new:
            raise AssertionError(f"int8 f32 request {rid}: {len(got[rid])} "
                                 f"/ {len(ref[rid])} tokens of {max_new}")
        mismatch = next((i for i, (a, b) in enumerate(zip(got[rid],
                                                          ref[rid]))
                         if a != b), None)
        agreed = max_new if mismatch is None else mismatch
        for (top_card, _), (top_cpu, _) in zip(gpu_gaps[rid][:agreed],
                                               cpu_gaps[rid][:agreed]):
            drift = max(drift, abs(top_card - top_cpu))
        if mismatch is None:
            identical += 1
            continue
        gap = cpu_gaps[rid][mismatch][1]
        if gap >= INT8_TIE_GAP:
            raise AssertionError(
                f"int8 f32 request {rid}: card token {got[rid][mismatch]} "
                f"!= CPU {ref[rid][mismatch]} at step {mismatch}, CPU "
                f"top-2 gap {gap} >= {INT8_TIE_GAP}")
        ties.append({"request": rid, "step": mismatch, "gap": gap})
    return {"requests": len(prompts), "identical": identical, "ties": ties,
            "tie_gap_limit": INT8_TIE_GAP,
            "top1_logit_drift_before_mismatch": drift,
            "min_cpu_gap": min(g for rid in prompts
                               for _, g in cpu_gaps[rid]),
            "card_s": card_s, "cpu_s": cpu_s}


@contextlib.contextmanager
def agent_preset(**changes):
    """The port's "1b" preset (the JAX package's: f32, max_seq 8192) with
    `changes` for the element to read at its setup, restored after."""
    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS
    base = LLAMA_PRESETS["1b"]
    LLAMA_PRESETS["1b"] = dataclasses.replace(base, **changes)
    try:
        yield LLAMA_PRESETS["1b"]
    finally:
        LLAMA_PRESETS["1b"] = base


def check_1b(config) -> None:
    if (config.dim, config.num_heads, config.num_kv_heads, config.ffn_dim,
            config.vocab) != (2048, 32, 8, 8192, 128256):
        raise AssertionError(f"not the 1b preset's widths: {config}")


def agent_texts(rng) -> dict:
    """{stream: [turn texts]}: turn 1 is the shared system preamble with
    the stream's first user text behind it, turns 2 and 3 are user text
    alone; user text is AGENT_TEXT_BYTES long, seeded words."""
    def text():
        n = int(rng.integers(*AGENT_TEXT_BYTES))
        words = []
        while sum(len(w) + 1 for w in words) < n:
            words.append(AGENT_WORDS[int(rng.integers(len(AGENT_WORDS)))])
        return " ".join(words)[:n]
    texts = {f"c{i}": [AGENT_PREAMBLE + " " + text(), text(), text()]
             for i in range(AGENT_STREAMS)}
    return texts


class RoundTimer:
    """Wall seconds of every ContinuousDecoder.pump that found work,
    by wrapping the class's pump (the element attaches the bound method
    at its first stream); restored by close()."""

    def __init__(self):
        from aiko_services_tpu_torch.serving import ContinuousDecoder
        self._class, self._pump = ContinuousDecoder, ContinuousDecoder.pump
        self.rounds = []
        timer, pump = self, self._pump

        def timed(decoder):
            if decoder.idle:
                return pump(decoder)
            start = time.perf_counter()
            pump(decoder)
            timer.rounds.append(time.perf_counter() - start)

        ContinuousDecoder.pump = timed

    def close(self) -> None:
        self._class.pump = self._pump


def count_extend_launches(decoder) -> list:
    """[extend dispatches, paged launches inside them], counted by
    wrapping the decoder's _extend_group."""
    from aiko_services_tpu_torch.ops import paged_attention as P
    counts = [0, 0]
    extend_group = decoder._extend_group

    def counted(*args, **kwargs):
        before = sum(P.launches.values())
        counts[0] += 1
        extend_group(*args, **kwargs)
        counts[1] += sum(P.launches.values()) - before

    decoder._extend_group = counted
    return counts


def agent_definition(parameters=None):
    from aiko_services_tpu_torch.pipeline import parse_pipeline_definition
    return parse_pipeline_definition({
        "version": 0, "name": "p_agent", "runtime": "python",
        "graph": ["(PE_LlamaAgent)"],
        "parameters": {f"PE_LlamaAgent.{key}": value for key, value in
                       (parameters or AGENT_PARAMETERS).items()},
        "elements": [{
            "name": "PE_LlamaAgent", "input": [{"name": "text"}],
            "output": [{"name": "response"}, {"name": "response_tokens"}],
            "parameters": {}}]})


def conversation(runtime, texts: dict, before_drive=None,
                 parameters=None, between_turns=None,
                 services_cache=None, frame_deadline: float = 0.0) -> tuple:
    """Drive AGENT_STREAMS streams through their turns on the runtime's
    virtual clock: every stream posts turn 1 at once, and each later
    turn as soon as the stream's previous turn came back; with
    `between_turns`, in lockstep instead: turn k + 1 is posted on every
    stream once every stream's turn k came back, after
    between_turns(k).  `services_cache` is the pipeline's discovery
    cache; `frame_deadline` > 0 gives every frame that end-to-end
    deadline (engine-clock seconds from its creation).  Returns (pipeline, agent element, frames by (stream, turn),
    virtual s, wall s)."""
    from aiko_services_tpu_torch.pipeline import Pipeline
    engine = runtime.event
    pipeline = Pipeline(runtime, agent_definition(parameters),
                        stream_lease_time=0, services_cache=services_cache,
                        frame_deadline=frame_deadline)
    done = []
    pipeline.add_frame_handler(done.append)
    for stream_id in texts:
        pipeline.create_stream(stream_id, lease_time=0)
    agent = pipeline.graph.node("PE_LlamaAgent").element
    if before_drive is not None:
        before_drive(agent)
    frames, turn_of = {}, {stream_id: 0 for stream_id in texts}
    total = sum(len(turns) for turns in texts.values())
    start, virtual_start = time.perf_counter(), engine.clock.now()
    for stream_id, turns in texts.items():
        pipeline.post("process_frame", stream_id, {"text": turns[0]})
    seen, posted = 0, 1
    while len(done) < total:
        for frame in done[seen:]:
            stream_id = frame.stream_id
            frames[(stream_id, turn_of[stream_id])] = frame
            turn_of[stream_id] += 1
            if between_turns is None and \
                    turn_of[stream_id] < len(texts[stream_id]):
                pipeline.post("process_frame", stream_id,
                              {"text": texts[stream_id][turn_of[stream_id]]})
        seen = len(done)
        if between_turns is not None and len(done) < total and \
                min(turn_of.values()) == posted:
            between_turns(posted)
            for stream_id in texts:
                pipeline.post("process_frame", stream_id,
                              {"text": texts[stream_id][posted]})
            posted += 1
        engine.clock.advance(0.002)
        while engine.step():
            pass
        if engine.clock.now() - virtual_start > 120.0:
            raise AssertionError(f"{len(done)} of {total} agent frames "
                                 f"in 120 virtual s")
    for frame in done[seen:]:
        frames[(frame.stream_id, turn_of[frame.stream_id])] = frame
        turn_of[frame.stream_id] += 1
    return (pipeline, agent, frames, engine.clock.now() - virtual_start,
            time.perf_counter() - start)


def phase_agent() -> tuple:
    """A one-element pipeline (PE_LlamaAgent) serving Llama-1B at full
    width in bf16 through the paged decoder with the prefix cache and
    sessions: 8 streams x 3 turns on a virtual clock.  Returns (the paged
    kernel's launches by path in that run, the run's tokens and counts
    for agent_mesh)."""
    import numpy as np

    from aiko_services_tpu_torch.event import settle_virtual
    from aiko_services_tpu_torch.ops import paged_attention as P

    with agent_preset(dtype=torch.bfloat16) as config:
        check_1b(config)
        if config.num_layers != 16:
            raise AssertionError(f"not 16 layers: {config}")
        runtime, compute = host_runtime()
        engine = runtime.event
        texts = agent_texts(np.random.default_rng(AGENT_SEED))
        extends, submitted = [], []

        def before_drive(agent):
            extends.extend([count_extend_launches(agent.decoder)])
            submit = agent.decoder.submit

            def recording(request_id, prompt, *args, **kwargs):
                submitted.append(len(prompt))
                return submit(request_id, prompt, *args, **kwargs)
            agent.decoder.submit = recording
            # the main path's run: counts set to 0 just before
            for name in P.launches:
                P.launches[name] = 0

        timer = RoundTimer()
        try:
            pipeline, agent, frames, virtual_s, wall_s = conversation(
                runtime, texts, before_drive)
        finally:
            timer.close()
        torch.cuda.synchronize()
        launches = dict(P.launches)
    decoder, cache = agent.decoder, agent.prefix_cache
    stats = dict(decoder.stats)
    extend_dispatches, extend_launches = extends[0]
    decode_launches = launches["paged_decode_attention"] - extend_launches
    failed = pipeline.recovery_stats["frames_failed"]
    if len(frames) != AGENT_STREAMS * AGENT_TURNS or failed:
        raise AssertionError(f"{len(frames)} agent frames, {failed} failed")
    for (stream_id, turn), frame in frames.items():
        tokens = frame.swag["response_tokens"]
        if len(tokens) != AGENT_PARAMETERS["max_tokens"] or not all(
                0 <= t < config.vocab for t in tokens) or \
                not isinstance(frame.swag["response"], str):
            raise AssertionError(f"agent frame {stream_id} turn {turn}: "
                                 f"{len(tokens)} tokens")
    expected = {"decode": config.num_layers * AGENT_DECODE_STEPS,
                "extend": config.num_layers * AGENT_EXTEND_DISPATCHES}
    measured = {"decode": decode_launches, "extend": extend_launches}
    if measured != expected or stats["steps"] != AGENT_DECODE_STEPS or \
            extend_dispatches != AGENT_EXTEND_DISPATCHES or \
            launches["paged_decode_attention_int8_fold"] or \
            launches["paged_decode_attention_int8_dequant"]:
        raise AssertionError(
            f"agent paged launches {measured} != {expected} "
            f"({stats['steps']} decode steps, {extend_dispatches} extend "
            f"dispatches; predicted {AGENT_DECODE_STEPS} and "
            f"{AGENT_EXTEND_DISPATCHES}), all {launches}")
    if stats["prefix_admits"] < AGENT_MIN_PREFIX_ADMITS:
        raise AssertionError(f"{stats['prefix_admits']} prefix admits")
    prompt_tokens = sum(submitted)
    cache_stats = dict(cache.stats)
    if stats["tokens_prefill"] + cache_stats["hit_tokens"] != prompt_tokens:
        raise AssertionError(
            f"prefilled {stats['tokens_prefill']} + cached "
            f"{cache_stats['hit_tokens']} != {prompt_tokens} prompt tokens")
    used, resident = decoder.pool.used_blocks(), len(cache)
    if used != resident:
        raise AssertionError(f"{used} pool blocks owned with the decoder "
                             f"idle, {resident} cached")

    # one round with prefix-hit extends under the profiler: a fourth turn
    # on every stream, its admits (table edits) and suffix extends
    for stream_id in texts:
        pipeline.post("process_frame", stream_id, {"text": "and then?"})
    while engine.step():
        pass
    profile = profile_round(decoder, "agent prefix-hit admits + extends")
    drained = engine.clock.now() + 60.0
    while not decoder.idle and engine.clock.now() < drained:
        engine.clock.advance(0.002)
        while engine.step():
            pass
    # the leases lapse: the table's expiry releases every session pin
    table = agent._session_table
    sessions_before = len(table)
    settle_virtual(engine, AGENT_PARAMETERS["session_lease"] + 1.0)
    pinned = sum(1 for node in cache._nodes.values() if node.refs)
    if len(table) or pinned:
        raise AssertionError(f"{len(table)} sessions and {pinned} pinned "
                             f"cache blocks after the leases lapsed")
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    evicted = cache.purge()
    if decoder.pool.used_blocks():
        raise AssertionError(f"{decoder.pool.used_blocks()} pool blocks "
                             f"owned after purge")
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    rounds = timer.rounds
    record = {
        "phase": "agent", "streams": AGENT_STREAMS, "turns": AGENT_TURNS,
        "frames": len(frames), "frames_failed": failed,
        "prompt_tokens": prompt_tokens,
        "tokens_prefill": stats["tokens_prefill"],
        "hit_tokens": cache_stats["hit_tokens"],
        "hit_rate": cache_stats["hit_tokens"] / prompt_tokens,
        "prefix_admits": stats["prefix_admits"],
        "dedup_deferred": stats["dedup_deferred"],
        "dedup_shared": stats["dedup_shared"],
        "cow_copies": stats["cow_copies"],
        "session_handles": cache_stats["session_handles"],
        "session_released": cache.stats["session_released"],
        "sessions_before_expiry": sessions_before,
        "decode_steps": stats["steps"],
        "extend_dispatches": extend_dispatches,
        "paged_launches": measured, "paged_launches_expected": expected,
        "prefill_chunks": stats["prefill_chunks"],
        "pool_blocks_used_idle": used, "cache_blocks": resident,
        "evicted_by_purge": evicted, "pool_blocks_used_after_purge":
            decoder.pool.used_blocks(),
        "pool_blocks": decoder.pool.num_blocks - 1,
        "virtual_s": virtual_s, "wall_s": wall_s,
        "rounds": len(rounds), "first_round_s": rounds[0],
        "steady_round_s": statistics.median(rounds[2:]),
        "tokens": sum(len(f.swag["response_tokens"])
                      for f in frames.values()),
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(record)
    emit({"phase": "profile", **profile})
    return measured, agent_outcome(frames, stats, cache_stats)


def agent_outcome(frames: dict, stats: dict, cache_stats: dict) -> dict:
    """What two drives of the agent's conversation compare: each
    (stream, turn)'s tokens, the prefill and hit tokens, the prefix
    admits and the decode steps."""
    return {"tokens": {f"{stream}/{turn}": [int(t) for t in
                                             frame.swag["response_tokens"]]
                       for (stream, turn), frame in frames.items()},
            "tokens_prefill": stats["tokens_prefill"],
            "hit_tokens": cache_stats["hit_tokens"],
            "prefix_admits": stats["prefix_admits"],
            "decode_steps": stats["steps"]}


def greedy_check(params, config, prompt, got, label) -> dict | None:
    """got against llama_greedy_decode on `prompt` (dense cache, plain
    attention); None when identical, the tie's record when the first
    mismatch's reference top-2 logit gap is under 1e-4; raises
    otherwise."""
    from aiko_services_tpu_torch.models.llama import (llama_forward,
                                                      llama_greedy_decode)
    device = params.embed.table.device
    with torch.inference_mode():
        ref = llama_greedy_decode(params, config, torch.tensor(
            [prompt], device=device), max_tokens=len(got))[0].tolist()
        if got == ref:
            return None
        i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
        logits = llama_forward(params, config, torch.tensor(
            [prompt + ref[:i]], device=device))[0, -1]
    top2 = torch.topk(logits, 2).values
    gap = (top2[0] - top2[1]).item()
    if gap >= 1e-4:
        raise AssertionError(f"{label}: token {got[i]} != dense {ref[i]} "
                             f"at step {i}, top-2 gap {gap}")
    return {"request": label, "step": i, "gap": gap}


def phase_agent_f32() -> dict:
    """The same conversation at full width and 2 layers in f32 on the
    card: each turn's response against llama_greedy_decode on that
    turn's whole history prompt, under phase_llama_f32's tie rule."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with agent_preset(num_layers=2, dtype=torch.float32) as config:
        check_1b(config)
        runtime, compute = host_runtime()
        prompts = {}

        def before_drive(agent):
            submit = agent.decoder.submit

            def recording(request_id, prompt, *args, **kwargs):
                prompts[request_id] = list(prompt)
                return submit(request_id, prompt, *args, **kwargs)
            agent.decoder.submit = recording

        pipeline, agent, frames, virtual_s, wall_s = conversation(
            runtime, agent_texts(np.random.default_rng(AGENT_SEED)),
            before_drive)
        ties, identical = [], 0
        for frame in frames.values():
            request_id = f"{frame.stream_id}.{frame.frame_id}"
            tie = greedy_check(agent.params, config, prompts[request_id],
                               list(frame.swag["response_tokens"]),
                               request_id)
            if tie is None:
                identical += 1
            else:
                ties.append(tie)
    stats = agent.decoder.stats
    if len(frames) != AGENT_STREAMS * AGENT_TURNS or \
            stats["prefix_admits"] < AGENT_MIN_PREFIX_ADMITS:
        raise AssertionError(f"{len(frames)} frames, "
                             f"{stats['prefix_admits']} prefix admits")
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    record = {"phase": "agent_f32", "frames": len(frames),
              "identical": identical, "ties": ties,
              "prefix_admits": stats["prefix_admits"],
              "cow_copies": stats["cow_copies"],
              "hit_tokens": agent.prefix_cache.stats["hit_tokens"],
              "longest_prompt": max(len(p) for p in prompts.values()),
              "virtual_s": virtual_s, "wall_s": wall_s}
    emit(record)
    return record


def phase_assistant() -> dict:
    """examples/speech/pipeline_assistant.json on the port: PE_MicrophoneSim
    → PE_LogMel → PE_WhisperASR (Whisper-small, buckets [500], 5 s
    chunks) → PE_LlamaAgent (Llama-1B in bf16, continuous, paged, prefix
    cache, sessions) → PE_NeuralTTS (the base preset, Griffin-Lim) →
    PE_Speaker; 4 streams x 3 chunks on a virtual clock."""
    import numpy as np

    from aiko_services_tpu_torch.pipeline import (Pipeline,
                                                  parse_pipeline_definition)

    path = "examples/speech/pipeline_assistant.json"
    with open(path) as file:
        raw = json.load(file)
    raw["parameters"].update(ASSISTANT_OVERRIDES)
    with agent_preset(dtype=torch.bfloat16) as config:
        check_1b(config)
        definition = parse_pipeline_definition(raw, source=path)
        runtime, compute = host_runtime()
        engine = runtime.event
        pipeline = Pipeline(runtime, definition, stream_lease_time=0)
        done = []
        pipeline.add_frame_handler(done.append)
        streams = {f"a{i}": {"PE_MicrophoneSim.limit": ASSISTANT_CHUNKS,
                             "PE_MicrophoneSim.frequency": 200.0 + 60 * i}
                   for i in range(ASSISTANT_STREAMS)}
        expected = ASSISTANT_STREAMS * ASSISTANT_CHUNKS
        start = time.perf_counter()
        for stream_id, parameters in streams.items():
            pipeline.create_stream(stream_id, parameters=parameters,
                                   lease_time=0)
        while len(done) < expected and engine.clock.now() < 120.0:
            while engine.step():
                pass
            engine.clock.advance(0.002)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
    asr = pipeline.graph.node("PE_WhisperASR").element
    agent = pipeline.graph.node("PE_LlamaAgent").element
    failed = pipeline.recovery_stats["frames_failed"]
    if len(done) != expected or failed:
        raise AssertionError(f"{len(done)} of {expected} assistant frames, "
                             f"{failed} failed")
    whisper = asr.config
    if (whisper.dim, whisper.num_heads, whisper.enc_layers,
            whisper.dec_layers, whisper.n_vocab) != WHISPER_SMALL or \
            asr.buckets != [500]:
        raise AssertionError(f"not Whisper-small in bucket 500: {whisper}")
    tts = pipeline.graph.node("PE_NeuralTTS").element
    if (tts.config.dim, tts.config.num_layers, tts.config.max_frames,
            tts.max_tokens) != (128, 4, 1024, 128) or tts.vocoder is not None:
        raise AssertionError(f"not the base TTS preset: {tts.config}")
    for frame in done:
        # the frame's audio is the voice's (whole hops of PE_NeuralTTS's
        # Griffin-Lim output), not the microphone's 5 s chunk
        swag = frame.swag
        audio = np.asarray(swag.get("audio"))
        if not isinstance(swag.get("text"), str) or \
                not isinstance(swag.get("response"), str) or \
                len(swag["response_tokens"]) != 32 or \
                swag.get("sample_rate") != 16000 or \
                audio.dtype != np.float32 or audio.size < 160 or \
                audio.size % 160 or not np.all(np.isfinite(audio)):
            raise AssertionError(f"assistant frame {frame.stream_id}:"
                                 f"{frame.frame_id}: {sorted(swag)}")
    speaker = {sid: stream.variables.get("speaker.audio")
               for sid, stream in pipeline.streams.items()}
    voiced = {sid: sum(len(f.swag["audio"]) for f in done
                       if f.stream_id == sid) for sid in streams}
    if {sid: 0 if audio is None else int(audio.size)
            for sid, audio in speaker.items()} != voiced:
        raise AssertionError("PE_Speaker did not collect PE_NeuralTTS's "
                             "audio of every frame")
    stats = agent.decoder.stats
    program = compute.programs["whisper_asr.PE_WhisperASR"]
    batches = len(program.first_call_times) + len(program.recent_service)
    if stats["prefix_admits"] < ASSISTANT_MIN_PREFIX_ADMITS or \
            agent.compute is not compute or asr.compute is not compute or \
            tts.compute is not compute or \
            agent.decoder.device != compute.device or not batches:
        raise AssertionError(
            f"{stats['prefix_admits']} prefix admits; the agent's and the "
            f"ASR's ComputeRuntime: {agent.compute} / {asr.compute}")
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    tts_program = compute.programs[tts._program]
    record = {"phase": "assistant",
              "streams": len(streams), "frames": len(done),
              "frames_failed": failed,
              "frames_with_text": sum(1 for f in done if f.swag["text"]),
              "whisper_batches": batches,
              "mean_batch_size": asr.scheduler.mean_batch_size(),
              "agent_completed": stats["completed"],
              "prefix_admits": stats["prefix_admits"],
              "tokens_prefill": stats["tokens_prefill"],
              "hit_tokens": agent.prefix_cache.stats["hit_tokens"],
              "speaker_samples": {sid: int(audio.size)
                                  for sid, audio in speaker.items()},
              "tts_batches": len(tts_program.first_call_times) +
              len(tts_program.recent_service),
              "tts_samples": sorted(len(f.swag["audio"]) for f in done),
              "virtual_s": engine.clock.now(), "wall_s": wall_s,
              "compute_programs": sorted(compute.programs)}
    emit(record)
    return record


def phase_remote_pipeline() -> tuple:
    """examples/speech/pipeline_transcription_remote.json on the port,
    unedited: the caller's remote_asr hop crosses the binary wire, with
    the i8mel codec, to a serving pipeline p_transcription_server
    ((PE_WhisperASR (PE_Synthesize)), Whisper-small in bf16 on the card,
    behind an AdmissionGate reading the scheduler's wait estimate) that
    the caller finds through the registrar.  Registrar, server and
    caller are three runtimes on one broker and one engine under a
    virtual clock.  Returns the kernel launch counts of that run and the
    caller's tokens by (stream, frame)."""
    return remote_transcription("remote_pipeline")


def phase_peer_pipeline(reference: dict) -> tuple:
    """The remote_pipeline phase's run with one change: the caller's and
    the server's runtime both call enable_peer(kinds=("tcp",)) on
    127.0.0.1, so every request and reply envelope of the hop crosses a
    real TCP socket and none rides the broker.  The caller's tokens must
    equal `reference` (the remote_pipeline phase's) frame by frame."""
    return remote_transcription("peer_pipeline", peer={},
                                reference=reference)


def phase_peer_chaos(reference: dict) -> tuple:
    """The peer_pipeline phase's traffic over the same TCP channels with
    a seeded FaultPlan on each side's channel: the caller's drops a fifth
    of its request envelopes, the server's delays half of its replies by
    0.2 s; the caller retries a hop whose 3 s lease expires (up to 4
    times).  Every frame completes, with the tokens of `reference` (the
    peer_pipeline phase's)."""
    return remote_transcription("peer_chaos", peer=PEER_CHAOS,
                                reference=reference)


def remote_transcription(phase: str, peer: dict | None = None,
                         reference: dict | None = None) -> tuple:
    """The remote transcription example's run for the remote_pipeline
    phase (peer None: the hop rides the broker) and the peer phases
    (peer: {} for clean TCP channels, or PEER_CHAOS's fault rules,
    retries and lease).  Returns the kernel launch counts of that run and
    the caller's tokens by (stream, frame)."""
    import numpy as np

    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.observe.metrics import default_registry
    from aiko_services_tpu_torch.ops import attention as A
    from aiko_services_tpu_torch.ops.admission import AdmissionGate
    from aiko_services_tpu_torch.ops.audio import mel_i8_pack, mel_i8_unpack
    from aiko_services_tpu_torch.pipeline import (
        Pipeline, load_pipeline_definition, parse_pipeline_definition)
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.registrar import Registrar
    from aiko_services_tpu_torch.share import ServicesCache
    from aiko_services_tpu_torch.transport import (MemoryBroker,
                                                   MemoryMessage, wire)
    from aiko_services_tpu_torch.transport.chaos import FaultPlan
    from aiko_services_tpu_torch.transport.peer import in_flight

    engine, broker = EventEngine(VirtualClock()), MemoryBroker()

    def runtime(name):
        def transport(on_message, lwt_topic, lwt_payload, lwt_retain):
            return MemoryMessage(on_message=on_message, broker=broker,
                                 lwt_topic=lwt_topic,
                                 lwt_payload=lwt_payload,
                                 lwt_retain=lwt_retain)
        return ProcessRuntime(name=name, engine=engine,
                              transport_factory=transport).initialize()

    def settle():
        while engine.step():
            pass

    reg_rt = runtime("reg")
    registrar = Registrar(reg_rt)
    engine.clock.advance(2.1)           # past the 2.0 s primary search
    settle()
    if not registrar.is_primary:
        raise AssertionError("the registrar did not become primary")

    # the peer phases: one seeded FaultPlan on each side's channel (no
    # rule in peer_pipeline), a TCP endpoint on 127.0.0.1 for both
    chaos = peer or {}
    plans = tuple(FaultPlan(seed=seed)
                  for seed in chaos.get("seeds", (0, 1)))
    hosts = ()

    # the server: PE_WhisperASR with the local example's parameters and
    # only the hallucination gates opened, then PE_Synthesize
    serve_rt = runtime("serve")
    if peer is not None:
        serve_host = serve_rt.enable_peer(
            kinds=("tcp",), fault_plan=plans[1] if peer else None)
    compute = ComputeRuntime(serve_rt, "compute")
    local = load_pipeline_definition(
        "examples/speech/pipeline_transcription.json")
    parameters = {key: value for key, value in local.parameters.items()
                  if key.startswith("PE_WhisperASR.")}
    parameters.update({"PE_WhisperASR.logprob_threshold": -1e9,
                       "PE_WhisperASR.compression_ratio_threshold": 1e9})
    server_definition = parse_pipeline_definition({
        "version": 0, "name": "p_transcription_server", "runtime": "jax",
        "graph": ["(PE_WhisperASR (PE_Synthesize))"],
        "parameters": parameters,
        "elements": [
            {"name": "PE_WhisperASR", "input": [{"name": "mel"}],
             "output": [{"name": "tokens"}, {"name": "text"}]},
            {"name": "PE_Synthesize", "input": [{"name": "text"}],
             "output": [{"name": "audio"}]}]})
    gate = AdmissionGate(inflight_limit=128, metrics_labels={
        "pipeline": "p_transcription_server"})
    server = Pipeline(serve_rt, server_definition, stream_lease_time=0,
                      auto_create_streams=True, admission=gate)
    asr = server.graph.node("PE_WhisperASR").element
    gate.watch_scheduler(asr.scheduler)         # sets the model up
    served, served_by_mel = {}, {}

    def serve(frame):
        tokens = np.asarray(frame.swag["tokens"])
        served.setdefault((frame.stream_id, frame.frame_id), tokens)
        # what the server received: the i8mel-unpacked mel, which names
        # the caller's frame whatever order the frames arrived in
        served_by_mel.setdefault(
            (frame.stream_id, np.asarray(frame.swag["mel"]).tobytes()),
            tokens)
    server.add_frame_handler(serve)

    # the caller: the example, unedited; its wire_codecs parameter is
    # read by no run time, so it is passed as remote_wire_codecs
    call_rt = runtime("call")
    if peer is not None:
        call_host = call_rt.enable_peer(
            kinds=("tcp",), fault_plan=plans[0] if peer else None)
        hosts = (call_host, serve_host)
    definition = load_pipeline_definition(
        "examples/speech/pipeline_transcription_remote.json")
    codecs = dict(definition.parameters["wire_codecs"])
    caller = Pipeline(call_rt, definition,
                      services_cache=ServicesCache(call_rt),
                      stream_lease_time=0,
                      remote_timeout=chaos.get("timeout", 60.0),
                      remote_retries=chaos.get("retries", 0), retry_seed=3,
                      remote_wire_codecs=codecs)
    topics = {"server": f"{server.topic_path}/in",
              "caller": caller.topic_in}
    for plan, rules in zip(plans, (chaos.get("caller_rules", ()),
                                   chaos.get("serving_rules", ()))):
        for kind, rule in rules:
            getattr(plan, kind)(**{**rule,
                                   "topic": rule["topic"].format(**topics)})
    # every envelope to the server and back, as it crossed: on the
    # broker (spies on both topics) and, in the peer phases, as each
    # side's peer host handed it to its runtime
    requests, replies = [], []
    broker_requests, broker_replies = [], []
    for topic, into in ((topics["server"], broker_requests),
                        (topics["caller"], broker_replies)):
        spy = MemoryMessage(
            on_message=lambda _topic, payload, into=into: into.append(
                (engine.clock.now(), payload)), broker=broker)
        spy.connect()
        spy.subscribe(topic)
    if peer is None:
        requests, replies = broker_requests, broker_replies
    else:
        for rt, topic, into in ((serve_rt, topics["server"], requests),
                                (call_rt, topics["caller"], replies)):
            # the peer host calls runtime._on_transport_message for each
            # envelope off its channel (the broker holds the bound
            # method it was given at initialize)
            def delivered(topic_in, payload, ack=None, rt=rt, topic=topic,
                          into=into, deliver=rt._on_transport_message):
                if topic_in == topic:
                    into.append((engine.clock.now(), payload))
                deliver(topic_in, payload, ack)
            rt._on_transport_message = delivered
    settle()
    if not caller.remote_elements_ready():
        raise AssertionError("remote_asr was not discovered")
    if peer is not None:
        # the dial thread pins the caller's end, the accept thread the
        # server's: both before any frame
        deadline = time.monotonic() + 30.0
        while not (call_host.pinned(topics["server"]) and
                   serve_host.pinned(topics["caller"])):
            if time.monotonic() > deadline:
                raise AssertionError(f"no TCP channel: {call_host.info()}"
                                     f", {serve_host.info()}")
            settle()
            time.sleep(0.001)
    done, finished = [], {}

    def completed(frame):
        done.append(frame)
        finished[(frame.stream_id, frame.frame_id)] = engine.clock.now()
    caller.add_frame_handler(completed)

    # 4 short streams (1 s chunks, window 3: frames of 1-3 s, bucket
    # 500) and 2 long ones (10 s chunks: 10, 20, 30 s, buckets 1000 and
    # 3072)
    streams = {f"short{i}": {"PE_MicrophoneSim.limit": 4,
                             "PE_MicrophoneSim.frequency": 220.0 + 40 * i}
               for i in range(4)}
    streams.update({f"long{i}": {"PE_MicrophoneSim.chunk_seconds": 10.0,
                                 "PE_AudioFraming.window_count": 3,
                                 "PE_MicrophoneSim.limit": 3,
                                 "PE_MicrophoneSim.frequency": 180.0 + 70 * i}
                    for i in range(2)})
    expected = 4 * 4 + 2 * 3
    registry = default_registry()

    def wire_count(kind, pipeline, direction):
        return registry.value(f"pipeline_wire_{kind}_total",
                              {"pipeline": pipeline,
                               "direction": direction})

    def admission_count(family):
        return sum(metric.value for labels, metric in
                   registry.series(f"admission_{family}_total")
                   if labels.get("pipeline") == "p_transcription_server")
    before = {"request_envelopes": wire_count(
                  "envelopes", caller.name, "request"),
              "request_frames": wire_count("frames", caller.name, "request"),
              "reply_envelopes": wire_count(
                  "envelopes", server.name, "reply"),
              "reply_frames": wire_count("frames", server.name, "reply"),
              "admitted": admission_count("admitted"),
              "shed": admission_count("shed")}
    hops = registry.histogram("pipeline_hop_seconds",
                              labels={"pipeline": caller.name})
    hops_before = hops.count
    start = time.perf_counter()
    virtual_start = engine.clock.now()
    in_flight_waits = 0
    # the main path's run: counts set to 0 just before, read just after
    for name in A.launches:
        A.launches[name] = 0
    wire.host_copies.update(count=0, seconds=0.0)
    for stream_id, stream_parameters in streams.items():
        caller.create_stream(stream_id, parameters=stream_parameters,
                             lease_time=0)
    with flash_shapes() as shapes:
        while len(done) < expected and \
                engine.clock.now() - virtual_start < 60.0:
            settle()
            # the sockets deliver in wall time: the virtual clock waits
            # for every envelope on a socket to reach its engine
            while in_flight(hosts):
                in_flight_waits += 1
                time.sleep(0.0002)
                settle()
            engine.clock.advance(0.01)
        torch.cuda.synchronize()
    counts = dict(A.launches)
    copies = dict(wire.host_copies)
    wall_s = time.perf_counter() - start
    virtual_s = engine.clock.now() - virtual_start

    config = asr.config
    if (config.dim, config.num_heads, config.enc_layers, config.dec_layers,
            config.n_vocab) != WHISPER_SMALL or \
            asr.buckets != [500, 1000, 3072]:
        raise AssertionError(f"not Whisper-small in buckets [500, 1000, "
                             f"3072]: {config}, {asr.buckets}")
    failed = caller.recovery_stats["frames_failed"]
    if len(done) != expected or failed:
        raise AssertionError(f"{len(done)} of {expected} frames completed, "
                             f"{failed} failed; server "
                             f"{dict(server.recovery_stats)}")
    retries = caller.recovery_stats["retries"]
    # what crossed: each request's mel is i8mel of the caller's own mel,
    # and the tokens merged at the caller are the server's
    crossed, sent_at, request_bytes = {}, {}, 0
    for when, payload in requests:
        request_bytes += len(payload)
        expr, buffers = wire.read_envelope(payload)
        entries = expr[1] if expr[0] == "process_frames_remote" \
            else [expr[1:]]
        for entry in entries:
            marker = entry[1]["mel"]
            if marker[5] != "i8mel":
                raise AssertionError(f"mel crossed as {marker}")
            crossed.setdefault(entry[0], []).append(
                bytes(buffers[int(marker[1])]))
            sent_at.setdefault(entry[0], []).append(when)
    frames_per_bucket, mel_bytes, hop_virtual, tokens_by_key = {}, 0, [], {}
    scheduler = asr.scheduler
    for frame in done:
        key = (frame.stream_id, frame.frame_id)
        swag = frame.swag
        tokens = np.asarray(swag["tokens"])
        tokens_by_key[key] = tokens
        mel = swag["mel"]
        if mel.device.type != "cuda":
            raise AssertionError(f"frame {key}: mel on {mel.device}")
        packed = mel_i8_pack(mel.cpu().numpy())
        if peer is None:
            served_tokens = served.get(key)
            crossed_ok = crossed[frame.stream_id][frame.frame_id] == \
                packed.tobytes()
            hop_virtual.append(finished[key] -
                               sent_at[frame.stream_id][frame.frame_id])
        else:
            # a retried request reaches the server after later frames of
            # its stream: match the served frame by the mel it received
            served_tokens = served_by_mel.get(
                (frame.stream_id, mel_i8_unpack(packed).tobytes()))
            crossed_ok = packed.tobytes() in crossed[frame.stream_id]
        if served_tokens is None or \
                not np.array_equal(tokens, served_tokens):
            raise AssertionError(f"frame {key}: caller tokens {tokens}, "
                                 f"server {served_tokens}")
        if not crossed_ok:
            raise AssertionError(f"frame {key}: the bytes that crossed are "
                                 f"not mel_i8_pack of the caller's mel")
        if reference is not None and \
                not np.array_equal(tokens, reference.get(key)):
            raise AssertionError(f"frame {key}: tokens {tokens}, the "
                                 f"reference phase's {reference.get(key)}")
        if tokens.size == 0 or tokens.min() < 0 or \
                tokens.max() >= config.n_vocab or \
                not isinstance(swag["text"], str) or not swag["text"] or \
                not np.asarray(swag["audio"]).size:
            raise AssertionError(f"frame {key}: tokens {tokens}, swag "
                                 f"{sorted(swag)}")
        mel_bytes += mel.numel() * 4
        bucket = scheduler.buckets.bucket_for(mel.shape[0])
        frames_per_bucket[bucket] = frames_per_bucket.get(bucket, 0) + 1
    wire_counts = {
        "request_envelopes": wire_count("envelopes", caller.name,
                                        "request"),
        "request_frames": wire_count("frames", caller.name, "request"),
        "reply_envelopes": wire_count("envelopes", server.name, "reply"),
        "reply_frames": wire_count("frames", server.name, "reply"),
        "admitted": admission_count("admitted"),
        "shed": admission_count("shed")}
    wire_counts = {key: value - before[key]
                   for key, value in wire_counts.items()}
    dropped = plans[0].stats["drop"]
    for direction in ("request", "reply"):
        envelopes = wire_counts[f"{direction}_envelopes"]
        if not 0 < envelopes <= expected + retries:
            raise AssertionError(f"{envelopes} {direction} envelopes for "
                                 f"{expected} frames")
    # each retry sends its frame again; a dropped envelope never arrives
    if wire_counts["request_frames"] != expected + retries or \
            len(requests) + dropped != wire_counts["request_envelopes"]:
        raise AssertionError(f"wire counts {wire_counts}, "
                             f"{len(requests)} request envelopes seen, "
                             f"{dropped} dropped, {retries} retries")
    if wire_counts["admitted"] != expected or wire_counts["shed"] or \
            server.recovery_stats["shed_early"]:
        raise AssertionError(f"admission: {wire_counts}, server "
                             f"{dict(server.recovery_stats)}")
    if hops.count - hops_before != expected:
        raise AssertionError(f"pipeline_hop_seconds counted "
                             f"{hops.count - hops_before} hops")
    if caller._pending_remote:
        raise AssertionError(f"hops pending: {list(caller._pending_remote)}")
    # one device-to-host copy per frame the wire encoded
    if copies["count"] != wire_counts["request_frames"]:
        raise AssertionError(f"{copies['count']} device-to-host copies on "
                             f"the wire for "
                             f"{wire_counts['request_frames']} frames sent")
    channel = {}
    if peer is not None:
        if broker_requests or broker_replies:
            raise AssertionError(
                f"{len(broker_requests)} requests and {len(broker_replies)}"
                f" replies of the hop rode the broker")
        call_stats, serve_stats = dict(call_host.stats), \
            dict(serve_host.stats)
        ends = [getattr(end, "inner", end) for host in hosts
                for end in host._channels.values()]
        if [end.kind for end in ends] != ["tcp", "tcp"] or \
                call_stats["handshakes"] != 1 or call_stats["fallback"] or \
                serve_stats["fallback"]:
            raise AssertionError(f"peer channels {[e.info() for e in ends]}"
                                 f", caller {call_stats}, server "
                                 f"{serve_stats}")
        if len(replies) != wire_counts["reply_envelopes"]:
            raise AssertionError(f"{len(replies)} replies off the channel, "
                                 f"{wire_counts['reply_envelopes']} sent")
        injected = (dict(plans[0].stats), dict(plans[1].stats))
        if peer and not (dropped and retries and plans[1].stats["delay"]):
            raise AssertionError(f"faults {injected}, {retries} retries")
        channel = {
            "kind": "tcp", "handshakes": call_stats["handshakes"],
            "request_envelopes_on_channel": len(requests),
            "reply_envelopes_on_channel": len(replies),
            "request_bytes_on_channel": request_bytes,
            "reply_bytes_on_channel": sum(len(p) for _, p in replies),
            "broker_envelopes_of_the_hop":
                len(broker_requests) + len(broker_replies),
            "caller_host": {k: call_stats[k] for k in
                            ("sent", "received", "fallback", "tx_shed")},
            "server_host": {k: serve_stats[k] for k in
                            ("sent", "received", "fallback", "tx_shed")},
            "faults_injected": injected,
            "in_flight_waits": in_flight_waits}
    program = compute.programs["whisper_asr.PE_WhisperASR"]
    batches = {bucket: 1 for bucket in program.first_call_times}
    for bucket, _ in program.recent_service:
        batches[bucket] += 1
    long_batches = batches.get(3072, 0)
    expected_flash = config.enc_layers * long_batches
    if not long_batches or counts["flash_attention"] != expected_flash:
        raise AssertionError(f"flash launches {counts['flash_attention']} "
                             f"!= 12 x {long_batches} bucket-3072 batches")
    flash_shape = check_flash_shapes(phase, shapes.seen)
    mean_batch = scheduler.mean_batch_size()
    for pipeline in (caller, server):
        for stream_id in list(pipeline.streams):
            pipeline.destroy_stream(stream_id)
    caller.stop()
    server.stop()
    compute.stop()
    for rt in (call_rt, serve_rt, reg_rt):
        rt.terminate()
    live_timers = engine.live_timer_handlers()
    if live_timers:
        raise AssertionError(f"timers left after teardown: {live_timers}")
    reply_bytes = sum(len(payload) for _, payload in replies)
    record = {
        "phase": phase, "streams": len(streams),
        "frames": len(done), "frames_failed": failed,
        "frames_per_bucket": frames_per_bucket,
        "batches_per_bucket": batches, "mean_batch_size": mean_batch,
        "wire": wire_counts,
        "frames_per_request_envelope":
            wire_counts["request_frames"] / wire_counts["request_envelopes"],
        "frames_per_reply_envelope":
            wire_counts["reply_frames"] / wire_counts["reply_envelopes"],
        "request_bytes_per_frame": request_bytes / expected,
        "f32_mel_bytes_per_frame": mel_bytes / expected,
        "reply_bytes_per_frame": reply_bytes / expected,
        "virtual_s": virtual_s, "wall_s": wall_s,
        "device_to_host_copies": copies["count"],
        "device_to_host_copy_s": copies["seconds"],
        "device_to_host_copy_max_share_of_wall":
            copies["seconds"] / wall_s,
        "launches": counts, "flash_launches_expected": expected_flash,
        "flash_shape": flash_shape,
        "live_timers_after_teardown": len(live_timers)}
    if peer is None:
        record["hop_p50_virtual_s"] = statistics.median(hop_virtual)
    else:
        record.update({"channel": channel, "retries": retries,
                       "recovery": dict(caller.recovery_stats),
                       "tokens_equal_reference_frames": len(done)})
    emit(record)
    return counts, tokens_by_key


def phase_cli() -> dict:
    """The port's command line on the card: `pipeline show` and `pipeline
    params` on both speech examples (four children started together,
    each exiting 0); then the port's ProcessManager.spawn_python starts
    `python -m aiko_services_tpu_torch pipeline create
    examples/speech/pipeline_transcription.json --PE_MicrophoneSim.limit
    3`, whose ComputeRuntime takes the card (device None).  While it runs
    the card's free memory, as this process reads it, falls by at least
    CLI_MIN_FALL_GB (Whisper-small's ~241 M parameters in bf16); the
    child must not exit on its own, and ProcessManager.delete stops it."""
    import subprocess
    import threading

    from aiko_services_tpu_torch.event import EventEngine
    from aiko_services_tpu_torch.process_manager import ProcessManager

    module = "aiko_services_tpu_torch"
    examples = ("examples/speech/pipeline_transcription.json",
                "examples/speech/pipeline_transcription_remote.json")
    start = time.perf_counter()
    children = [(command, path, subprocess.Popen(
                    [sys.executable, "-m", module, "pipeline", command, path],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
                for command in ("show", "params") for path in examples]
    shown = {}
    for command, path, child in children:
        out, err = child.communicate(timeout=120)
        if child.returncode != 0 or not out:
            raise AssertionError(f"pipeline {command} {path}: exit "
                                 f"{child.returncode}: {err[-2000:]}")
        shown[f"{command} {os.path.basename(path)}"] = len(out.splitlines())
    show_s = time.perf_counter() - start

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_before, total = torch.cuda.mem_get_info()
    exits = []
    engine = EventEngine()
    manager = ProcessManager(
        engine, process_exit_handler=lambda *exit: exits.append(exit))
    lines, errors = [], []
    pid = manager.spawn_python(
        "cli", module, ["pipeline", "create", examples[0],
                        "--PE_MicrophoneSim.limit", "3"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    child = manager.processes["cli"]
    spawned = time.perf_counter()
    readers = [threading.Thread(target=lambda stream=stream, into=into:
                                into.extend(stream), daemon=True)
               for stream, into in ((child.stdout, lines),
                                    (child.stderr, errors))]
    for reader in readers:
        reader.start()
    fall_gb, started_s = 0.0, None
    try:
        deadline = spawned + CLI_TIMEOUT_S
        while time.perf_counter() < deadline:
            engine.step()           # the manager polls its child here
            if exits:
                raise AssertionError(f"the CLI child exited on its own: "
                                     f"{exits}: {''.join(errors)[-3000:]}")
            fall_gb = max(fall_gb, (free_before -
                                    torch.cuda.mem_get_info()[0]) / 1e9)
            if started_s is None and lines:
                started_s = time.perf_counter() - spawned
            if started_s is not None and fall_gb >= CLI_MIN_FALL_GB:
                break
            time.sleep(0.1)
        # it keeps running, streams done, until it is stopped
        hold = time.perf_counter() + 3.0
        while time.perf_counter() < hold:
            engine.step()
            time.sleep(0.1)
        if exits or child.poll() is not None:
            raise AssertionError(f"the CLI child exited on its own: "
                                 f"{exits}: {''.join(errors)[-3000:]}")
    finally:
        ran_s = time.perf_counter() - spawned
        manager.delete("cli")
        manager.terminate()
    for reader in readers:
        reader.join(timeout=10)
    if fall_gb < CLI_MIN_FALL_GB or not lines:
        raise AssertionError(f"the CLI child took {fall_gb:.3f} GB of the "
                             f"card, printed {lines}: "
                             f"{''.join(errors)[-3000:]}")
    if not lines[0].startswith("pipeline p_transcription on "):
        raise AssertionError(f"the CLI child's start line: {lines[0]!r}")
    # ProcessManager.delete (as in JAX) reports no exit to the handler:
    # the return code is the Popen's the manager held
    if child.returncode is None or exits:
        raise AssertionError(f"the CLI child: return code "
                             f"{child.returncode}, exits {exits}")
    record = {"phase": "cli", "show_and_params_lines": shown,
              "show_and_params_s": show_s,
              "child": {"id": "cli", "pid": pid,
                        "return_code": child.returncode},
              "start_line": lines[0].strip(),
              "start_line_after_s": started_s,
              "card_free_memory_fall_gb": fall_gb,
              "card_total_gb": total / 1e9, "ran_s": ran_s}
    emit(record)
    return record


# -- the vision path ---------------------------------------------------------

def zero_attention_counts() -> None:
    from aiko_services_tpu_torch.ops import attention as A
    from aiko_services_tpu_torch.ops import paged_attention as PA
    for counts in (A.launches, PA.launches):
        for name in counts:
            counts[name] = 0


def attention_counts() -> dict:
    from aiko_services_tpu_torch.ops import attention as A
    from aiko_services_tpu_torch.ops import paged_attention as PA
    return {**A.launches, **PA.launches}


def moving_frames(streams: int, frames: int, size: int, seed: int) -> dict:
    """{(stream, frame): uint8 [size, size, 3]}: seeded noise with two
    bright rectangles per stream that move a few pixels a frame."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for s in range(streams):
        boxes = [(rng.integers(8, size - 96, 2), rng.integers(24, 80, 2),
                  rng.integers(-4, 5, 2), rng.integers(150, 256, 3))
                 for _ in range(2)]
        for f in range(frames):
            image = rng.integers(0, 64, (size, size, 3), dtype=np.uint8)
            for (x, y), (w, h), (dx, dy), colour in boxes:
                x0 = int(np.clip(x + dx * f, 0, size - w))
                y0 = int(np.clip(y + dy * f, 0, size - h))
                image[y0:y0 + h, x0:x0 + w] = colour
            out[(f"cam{s}", f)] = image
    return out


def detect_definition(**parameters):
    """examples/pipeline/pipeline_detect.json less its file source (the
    repo holds no video file): (PE_Detect (PE_Tracker)) at the example's
    parameters, plus `parameters`."""
    from aiko_services_tpu_torch.pipeline import parse_pipeline_definition

    path = "examples/pipeline/pipeline_detect.json"
    with open(path) as file:
        raw = json.load(file)
    raw["graph"] = ["(PE_Detect (PE_Tracker))"]
    raw["elements"] = [element for element in raw["elements"]
                       if element["name"] != "PE_VideoReadFile"]
    raw["parameters"].update({f"PE_Detect.{key}": value
                              for key, value in parameters.items()})
    return parse_pipeline_definition(raw, source=path)


def drive_frames(engine, pipeline, done: list, frames: dict, program,
                 limit_s: float) -> list:
    """Post every frame (frame f of every stream, then f + 1) and step
    the engine until each has come back into `done` (the pipeline's frame
    handler appends there); the virtual clock advances only while no
    batch is in flight.  Returns the frames this call completed."""
    first = len(done)
    for stream, f in sorted(frames, key=lambda key: (key[1], key[0])):
        pipeline.post("process_frame", stream, {"image": frames[(stream, f)]})
    start = time.perf_counter()
    while len(done) - first < len(frames):
        if time.perf_counter() - start > limit_s:
            raise AssertionError(f"{len(done) - first} of {len(frames)} "
                                 f"frames in {limit_s} s")
        busy = False
        while engine.step():
            busy = True
        if program.in_flight["now"]:
            time.sleep(0.0002)             # the results worker
        elif not busy:
            engine.clock.advance(0.01)
    return done[first:]


def check_detections(frame, classes: int) -> None:
    swag = frame.swag
    boxes, scores, labels = swag["boxes"], swag["scores"], swag["classes"]
    if not (len(boxes) == len(scores) == len(labels) ==
            len(swag["tracks"])) or \
            any(len(box) != 4 or not all(math.isfinite(v) for v in box)
                for box in boxes) or \
            any(not 0.0 < s <= 1.0 for s in scores) or \
            any(not 0 <= c < classes for c in labels):
        raise AssertionError(f"frame {frame.stream_id}:{frame.frame_id}: "
                             f"{len(boxes)} boxes, scores {scores[:4]}, "
                             f"classes {labels[:4]}")


def profile_detect_batch(compute, program_name: str, frames: list,
                         engine) -> dict:
    """One full batch submitted straight to the program under
    torch.profiler (profile_batch), then its results delivered."""
    program = compute.programs[program_name]
    got = []
    record = profile_batch(
        "detect", lambda: [compute.submit(program_name, "profile", frame,
                                          frame.shape[0],
                                          lambda _sid, r: got.append(r))
                           for frame in frames], program.scheduler)
    deadline = time.perf_counter() + 30.0
    while len(got) < len(frames) and time.perf_counter() < deadline:
        if not engine.step():
            time.sleep(0.0005)
    if len(got) != len(frames) or any(isinstance(r, Exception) for r in got):
        raise AssertionError(f"profiled batch: {len(got)} results")
    return record


@contextlib.contextmanager
def cudnn_tf32():
    """The detector's f32 forward with cuDNN's TF32 left on (its
    exact_f32 scopes made no-ops), to time what exact f32 costs."""
    from aiko_services_tpu_torch.models import detector, resnet
    saved = resnet.exact_f32
    before = torch.backends.cudnn.allow_tf32
    resnet.exact_f32 = detector.exact_f32 = \
        lambda dtype: contextlib.nullcontext()
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        resnet.exact_f32 = detector.exact_f32 = saved
        torch.backends.cudnn.allow_tf32 = before


def detect_forward_ms(element, frames: list) -> dict:
    """Device ms of the detect program (normalise, forward, decode) on one
    full batch of raw frames, by time_ms on the element's weights: f32
    with TF32 off (the element's path), f32 with cuDNN's TF32, and bf16
    convolutions (the element's dtype option)."""
    import copy

    import numpy as np

    from aiko_services_tpu_torch.models.detector import detect

    batch = torch.from_numpy(np.stack(frames)).cuda()
    scratch = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    config = element.config
    bf16 = dataclasses.replace(
        config, dtype=torch.bfloat16,
        backbone=dataclasses.replace(config.backbone, dtype=torch.bfloat16))
    params_bf16 = copy.deepcopy(element.params).to(torch.bfloat16)

    @torch.no_grad()
    def run(params, cfg):
        detect(params, cfg, batch.float() / 255.0, 0.3)

    times = {"f32": time_ms(lambda: run(element.params, config), scratch,
                            reps=10)}
    with cudnn_tf32():
        times["tf32"] = time_ms(lambda: run(element.params, config),
                                scratch, reps=10)
    times["bf16"] = time_ms(lambda: run(params_bf16, bf16), scratch,
                            reps=10)
    return times


def phase_detect(wire: str) -> dict:
    """The detect example's graph less its file source, at its own
    parameters (detector_r18, 256 x 256, max_batch 32, pipelined,
    max_in_flight 4, f32) on the `wire` ("raw" or "dct8", keep 16):
    DETECT_STREAMS x DETECT_FRAMES seeded frames posted into (PE_Detect
    (PE_Tracker)) after one warm-up batch.  Every frame completes with
    well-formed detections and tracks, the results worker keeps 2-4
    batches in flight, and no attention kernel launches."""
    import numpy as np

    from aiko_services_tpu_torch.elements import detect as detect_module
    from aiko_services_tpu_torch.ops.image_wire import dct8_wire_bytes
    from aiko_services_tpu_torch.pipeline import Pipeline

    phase = "detect" if wire == "raw" else f"detect_{wire}"
    start_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    runtime, compute = host_runtime()
    engine = runtime.event
    parameters = {"max_in_flight": DETECT_MAX_IN_FLIGHT}
    if wire != "raw":
        parameters.update({"wire": wire, "dct_keep": DCT_KEEP})
    pipeline = Pipeline(runtime, detect_definition(**parameters),
                        stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    frames = moving_frames(DETECT_STREAMS, DETECT_FRAMES, DETECT_SIZE,
                           DETECT_SEED)
    for s in range(DETECT_STREAMS):
        pipeline.create_stream(f"cam{s}", lease_time=0)
    pipeline.create_stream("warm", lease_time=0)
    element = pipeline.graph.node("PE_Detect").element
    config = element.config
    if (config.backbone.stage_sizes, config.backbone.width,
            config.head_channels, config.num_classes,
            config.max_detections, config.dtype, element.image_size,
            element.wire) != ((2, 2, 2, 2), 64, 64, 80, 32, torch.float32,
                              DETECT_SIZE, wire):
        raise AssertionError(f"not detector_r18 at {DETECT_SIZE}: {config}")
    program = compute.programs[element._program]
    scheduler = program.scheduler
    if scheduler.max_batch != 32 or scheduler.dispatch_gate is None:
        raise AssertionError("not the example's batch of 32, pipelined")
    # bytes each batch sends to the card (the element's one copy)
    sent = []
    host_to = detect_module._host_to

    def counted(device, array):
        sent.append(array.nbytes)
        return host_to(device, array)

    detect_module._host_to = counted
    try:
        warm = {("warm", f): frames[("cam0", f)] for f in range(2)}
        drive_frames(engine, pipeline, done, warm, program,
                     DETECT_TIMEOUT_S)
        program.in_flight["peak"] = 0
        batches_before = scheduler.stats["batches"]
        recent_before = len(program.recent_service)
        # the main path's run: counts set to 0 just before, read after
        zero_attention_counts()
        start = time.perf_counter()
        done = drive_frames(engine, pipeline, done, frames, program,
                            DETECT_TIMEOUT_S)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        counts = attention_counts()
    finally:
        detect_module._host_to = host_to
    if any(counts.values()):
        raise AssertionError(f"{phase}: attention kernels launched {counts}")
    failed = pipeline.recovery_stats["frames_failed"]
    if len(done) != len(frames) or failed:
        raise AssertionError(f"{phase}: {len(done)} of {len(frames)} frames "
                             f"completed, {failed} failed")
    for frame in done:
        check_detections(frame, config.num_classes)
    peak = program.in_flight["peak"]
    if not 2 <= peak <= DETECT_MAX_IN_FLIGHT or program.in_flight["now"]:
        raise AssertionError(f"{phase}: in_flight {program.in_flight}")
    batches = scheduler.stats["batches"] - batches_before
    steady = [s for _, s in list(program.recent_service)[recent_before:]]
    wire_bytes = dct8_wire_bytes(DETECT_SIZE, DETECT_SIZE, 3, DCT_KEEP) \
        if wire == "dct8" else DETECT_SIZE * DETECT_SIZE * 3
    per_frame = set(nbytes // scheduler.max_batch for nbytes in sent)
    if per_frame != {wire_bytes}:
        raise AssertionError(f"{phase}: {per_frame} bytes a frame slot, "
                             f"expected {wire_bytes}")
    tracks = {}
    for frame in sorted(done, key=lambda f: (f.stream_id, f.frame_id)):
        tracks.setdefault(frame.stream_id, set()).update(
            t["track_id"] for t in frame.swag["tracks"])
    record = {"phase": phase, "wire": wire, "streams": DETECT_STREAMS,
              "frames": len(done), "frames_failed": failed,
              "batches": batches,
              "mean_batch_size": len(done) / batches,
              "in_flight_peak": peak, "launches": counts,
              "h2d_bytes_per_frame": wire_bytes,
              "raw_bytes_per_frame": DETECT_SIZE * DETECT_SIZE * 3,
              "detections": sum(len(f.swag["scores"]) for f in done),
              "track_ids_per_stream": {sid: len(ids) for sid, ids in
                                       sorted(tracks.items())},
              "wall_s": wall_s, "frames_per_s": len(done) / wall_s,
              "first_call_s": program.first_call_times,
              "steady_batch_s": statistics.median(steady) if steady
              else None}
    batch_frames = [frames[key] for key in sorted(frames)][:32]
    record["profile"] = profile_detect_batch(compute, element._program,
                                             batch_frames, engine)
    if wire == "raw":
        record["forward_ms"] = detect_forward_ms(element, batch_frames)
    record["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    record["phase_s"] = time.perf_counter() - start_phase
    emit(record)
    return record


def detect_on(device, frames: dict, params=None):
    """The detect example's graph (raw wire) on `device` (None: the card;
    "cpu"); `params`, when given, replaces the element's weights.
    Returns ({(stream, frame): swag}, the element)."""
    from aiko_services_tpu_torch.pipeline import Pipeline

    runtime, compute = host_runtime(device)
    pipeline = Pipeline(runtime, detect_definition(), stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    for stream in sorted({stream for stream, _ in frames}):
        pipeline.create_stream(stream, lease_time=0)
    element = pipeline.graph.node("PE_Detect").element
    if params is not None:
        element.params.load_state_dict(params.state_dict())
    drive_frames(runtime.event, pipeline, done, frames,
                 compute.programs[element._program], DETECT_TIMEOUT_S)
    out = {(frame.stream_id, frame.frame_id): frame.swag for frame in done}
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    return out, element


def first_difference(got: dict, want: dict) -> int | None:
    """The first rank at which two frames' detections differ (class, or
    score beyond DETECT_SCORE_TOL, or one list ends), or None."""
    n = min(len(got["classes"]), len(want["classes"]))
    for i in range(n):
        if got["classes"][i] != want["classes"][i] or \
                abs(got["scores"][i] - want["scores"][i]) > DETECT_SCORE_TOL:
            return i
    return None if len(got["classes"]) == len(want["classes"]) else n


def phase_detect_f32() -> dict:
    """The same weights and frames through the port's detect graph on the
    card (f32, TF32 off) and on the CPU: classes and track ids equal,
    scores within DETECT_SCORE_TOL and boxes within DETECT_BOX_TOL pixels;
    a first mismatch in a frame's ranking passes only where the CPU's
    scores at that rank are within DETECT_TIE of each other (the rest of
    that stream is then not compared)."""
    import numpy as np

    frames = moving_frames(DETECT_F32_STREAMS, DETECT_F32_FRAMES,
                           DETECT_SIZE, DETECT_SEED + 1)
    zero_attention_counts()
    card, element = detect_on(None, frames)
    counts = attention_counts()
    if any(counts.values()):
        raise AssertionError(f"detect_f32: attention kernels {counts}")
    cpu, _ = detect_on("cpu", frames, params=element.params)
    score_err = box_err = 0.0
    ties, compared, detections = [], 0, 0
    tied_streams = set()
    for key in sorted(frames):
        if key[0] in tied_streams:
            continue                   # the tracker saw other boxes
        got, want = card[key], cpu[key]
        n = len(want["classes"])
        first = first_difference(got, want)
        if first is not None:
            # the CPU's scores at that rank: the next rank's, or the
            # threshold where the lists' lengths part
            scores = want["scores"] + [DETECT_THRESHOLD]
            gap = abs(scores[first] - scores[first + 1]) \
                if first < len(want["scores"]) else \
                abs(got["scores"][first] - DETECT_THRESHOLD)
            if gap >= DETECT_TIE:
                raise AssertionError(
                    f"detect_f32 {key}: rank {first} differs (card "
                    f"{got['classes'][first:first + 2]} "
                    f"{got['scores'][first:first + 2]}, CPU "
                    f"{want['classes'][first:first + 2]} "
                    f"{want['scores'][first:first + 2]}), CPU gap {gap}")
            ties.append([key[0], key[1], first, gap])
            tied_streams.add(key[0])
            n = first
        elif [t["track_id"] for t in got["tracks"]] != \
                [t["track_id"] for t in want["tracks"]]:
            raise AssertionError(f"detect_f32 {key}: track ids differ")
        if n:
            score_err = max(score_err, float(np.max(np.abs(np.subtract(
                got["scores"][:n], want["scores"][:n])))))
            box_err = max(box_err, float(np.max(np.abs(np.subtract(
                got["boxes"][:n], want["boxes"][:n])))))
        if box_err > DETECT_BOX_TOL:
            raise AssertionError(f"detect_f32 {key}: boxes differ by "
                                 f"{box_err} px")
        compared += 1
        detections += n
    if not detections:
        raise AssertionError("detect_f32: no detection to compare")
    record = {"phase": "detect_f32", "frames": len(frames),
              "frames_compared": compared, "detections_compared":
              detections, "max_score_err": score_err,
              "max_box_err_px": box_err, "ties": ties,
              "score_tol": DETECT_SCORE_TOL, "box_tol_px": DETECT_BOX_TOL,
              "tie_limit": DETECT_TIE, "launches": counts}
    emit(record)
    return record


def classify_definition():
    """classify's one-element pipeline: (PE_ImageClassify), ResNet-18 at
    224 x 224, batched, max_batch 32."""
    from aiko_services_tpu_torch.pipeline import parse_pipeline_definition
    return parse_pipeline_definition({
        "version": 0, "name": "p_classify", "runtime": "python",
        "graph": ["(PE_ImageClassify)"],
        "parameters": {"PE_ImageClassify.preset": "resnet18",
                       "PE_ImageClassify.image_size": 224,
                       "PE_ImageClassify.mode": "batched",
                       "PE_ImageClassify.max_batch": 32},
        "elements": [{"name": "PE_ImageClassify",
                      "input": [{"name": "image"}],
                      "output": [{"name": "class_id"},
                                 {"name": "confidence"}]}]})


def classify_inputs(count: int) -> dict:
    """The first `count` of classify's seeded 224 x 224 frames, frame i
    on stream cam{i % 8}."""
    import numpy as np
    rng = np.random.default_rng(CLASSIFY_SEED)
    return {(f"cam{i % 8}", i // 8): rng.integers(
        0, 256, (224, 224, 3), dtype=np.uint8) for i in range(count)}


def phase_classify() -> dict:
    """ResNet-18 at 224 x 224 (1000 classes, f32) through a one-element
    pipeline (PE_ImageClassify, batched, max_batch 32): CLASSIFY_FRAMES
    seeded frames posted at once after one full warm-up batch; the class ids
    equal the CPU port's on the same weights and frames, confidences
    within CLASSIFY_TOL of them (a top-2 probability gap under
    CLASSIFY_TIE on the CPU counts as a tie)."""
    import copy

    import numpy as np

    from aiko_services_tpu_torch.models.resnet import resnet_forward
    from aiko_services_tpu_torch.pipeline import Pipeline

    start_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    frames = classify_inputs(CLASSIFY_FRAMES)
    runtime, compute = host_runtime()
    engine = runtime.event
    pipeline = Pipeline(runtime, classify_definition(),
                        stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    for stream in ["warm"] + [f"cam{s}" for s in range(8)]:
        pipeline.create_stream(stream, lease_time=0)
    element = pipeline.graph.node("PE_ImageClassify").element
    config = element.config
    if (config.stage_sizes, config.width, config.num_classes,
            element.image_size) != ((2, 2, 2, 2), 64, 1000, 224):
        raise AssertionError(f"not ResNet-18 at 224: {config}")
    program = compute.programs[element._program]
    # one full warm-up batch: the first call at a batch shape carries
    # cuDNN's algorithm choice
    drive_frames(engine, pipeline, done, {("warm", f): frames[key] for f, key
                                          in enumerate(sorted(frames)[:32])},
                 program, 60.0)
    recent_before = len(program.recent_service)
    zero_attention_counts()
    start = time.perf_counter()
    done = drive_frames(engine, pipeline, done, frames, program, 120.0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    counts = attention_counts()
    if any(counts.values()):
        raise AssertionError(f"classify: attention kernels {counts}")
    got = {(f.stream_id, f.frame_id): f.swag for f in done}
    # the CPU port on the same weights: logits and probabilities of
    # every frame in one batch
    cpu_params = copy.deepcopy(element.params).cpu()
    batch = torch.from_numpy(np.stack([frames[key] for key in
                                       sorted(frames)]))
    with torch.no_grad():
        probs = torch.softmax(resnet_forward(
            cpu_params, config, batch.float() / 255.0), dim=-1)
    top2 = torch.topk(probs, 2, dim=-1)
    conf_err, ties = 0.0, []
    for row, key in enumerate(sorted(frames)):
        class_id = int(top2.indices[row, 0])
        confidence = float(top2.values[row, 0])
        gap = float(top2.values[row, 0] - top2.values[row, 1])
        swag = got[key]
        if swag["class_id"] != class_id:
            if gap >= CLASSIFY_TIE:
                raise AssertionError(f"classify {key}: class "
                                     f"{swag['class_id']} != CPU "
                                     f"{class_id} (gap {gap})")
            ties.append([key[0], key[1], gap])
            continue
        conf_err = max(conf_err, abs(swag["confidence"] - confidence))
    if conf_err > CLASSIFY_TOL:
        raise AssertionError(f"classify: confidences differ by {conf_err}")
    steady = [s for _, s in list(program.recent_service)[recent_before:]]
    batches = len(steady)
    record = {"phase": "classify", "frames": len(done),
              "frames_failed": pipeline.recovery_stats["frames_failed"],
              "batches": batches, "launches": counts,
              "max_confidence_err": conf_err, "ties": ties,
              "confidence_tol": CLASSIFY_TOL, "tie_limit": CLASSIFY_TIE,
              "wall_s": wall_s, "frames_per_s": len(done) / wall_s,
              "first_call_s": program.first_call_times,
              "steady_batch_s": statistics.median(steady) if steady
              else None,
              "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    record["phase_s"] = time.perf_counter() - start_phase
    emit(record)
    return record


def llama_1b(**changes):
    """The Llama-1B preset (2048 / 32 heads / 8 KV heads / 16 layers /
    128,256 vocab) in bf16 at max_seq_len 1024, with `changes`."""
    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS
    config = dataclasses.replace(LLAMA_PRESETS["1b"], dtype=torch.bfloat16,
                                 max_seq_len=1024, **changes)
    check_1b(config)
    return config


def zero_paged_counts() -> None:
    from aiko_services_tpu_torch.ops import paged_attention as P
    for name in P.launches:
        P.launches[name] = 0


def serve_requests(decoder, requests, first: int = 16,
                   sync_debug: bool = False) -> dict:
    """The Llama phases' drive: requests[:first] submitted at once, the
    rest after the first round, pump until idle (at most 500 rounds).
    With sync_debug, torch's sync debug mode warns at every call that
    synchronizes the stream, and the drive fails on any.  Returns the
    tokens by request, each round's seconds and extent, the wall s and
    the peak KV bytes."""
    done = {}

    def keep(request_id, tokens):
        done[request_id] = list(tokens)

    start = time.perf_counter()
    for rid, prompt, new in requests[:first]:
        decoder.submit(rid, prompt, new, keep)
    round_s, t_caps, kv_bytes = [], [], 0
    if sync_debug:
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            while True:
                round_start = time.perf_counter()
                decoder.pump()
                round_s.append(time.perf_counter() - round_start)
                t_caps.append(decoder._cache_t)
                kv_bytes = max(kv_bytes, decoder.kv_cache_bytes())
                if len(round_s) == 1:
                    for rid, prompt, new in requests[first:]:
                        decoder.submit(rid, prompt, new, keep)
                if decoder.idle:
                    break
                if len(round_s) > 500:
                    raise AssertionError(
                        "the decoder did not drain in 500 rounds")
    finally:
        if sync_debug:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    syncs = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message))
    if syncs:
        raise AssertionError(f"the decoder synchronized the stream beyond "
                             f"its one wait a round: {dict(syncs)}")
    budgets = {rid: new for rid, _, new in requests}
    if sorted(done) != sorted(budgets):
        raise AssertionError(f"{len(done)} of {len(budgets)} completed")
    for rid, tokens in done.items():
        if len(tokens) != budgets[rid] or \
                not all(0 <= t < decoder.config.vocab for t in tokens):
            raise AssertionError(f"request {rid}: {len(tokens)} tokens of "
                                 f"{budgets[rid]}")
    if decoder.paged and decoder.pool.used_blocks() != 0:
        raise AssertionError(f"{decoder.pool.used_blocks()} pool blocks "
                             f"still owned after the run")
    return {"done": done, "round_s": round_s, "t_caps": t_caps,
            "wall_s": wall, "kv_bytes_peak": kv_bytes,
            "kv_bytes_final": decoder.kv_cache_bytes()}


def served_record(run: dict, stats: dict, reference: dict | None,
                  gap_run: tuple | None = None) -> dict:
    """The numbers every Llama phase reports about its main run (`stats`:
    the decoder's counters just after it).  With `gap_run` (the tokens
    and logit gaps of reference_gaps), the top-2 gap of that run at each
    request's first token that differs from it."""
    tokens = sum(len(t) for t in run["done"].values())
    record = {"requests": len(run["done"]), "tokens": tokens,
              "wall_s": run["wall_s"], "tokens_per_s": tokens / run["wall_s"],
              "rounds": len(run["round_s"]), "first_round_s": run["round_s"][0],
              "steady_round_s": statistics.median(run["round_s"][2:]),
              "t_cap_max": max(run["t_caps"]), "steps": stats["steps"],
              "useful_steps": stats["useful_steps"],
              "wasted_steps": stats["wasted_steps"],
              "kv_cache_bytes_peak": run["kv_bytes_peak"],
              "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if reference is not None:
        # bf16 sums in another order than the reference run's: tokens may
        # split at near-ties, so agreement is reported, not required
        record["same_tokens_as_llama"] = sum(
            run["done"][rid] == reference[rid] for rid in run["done"]) / \
            len(run["done"])
    if gap_run is not None:
        tokens, gaps = gap_run
        at_split = [gaps[rid][next(i for i, (a, b) in enumerate(zip(
            got, tokens[rid])) if a != b)][1]
            for rid, got in run["done"].items() if got != tokens[rid]]
        record.update({
            "splits_from_gap_run": len(at_split),
            "max_gap_at_first_split": max(at_split, default=None),
            "gaps_at_first_split": sorted(at_split),
            "median_gap_of_gap_run": statistics.median(
                gap for rows in gaps.values() for _, gap in rows)})
    return record


def reference_gaps(params, config, requests) -> tuple:
    """The llama phase's decoder and traffic on `params` under LogitGaps:
    its tokens by request, and [top-1 logit, top-2 gap] per emitted
    token by request."""
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    decoder = ContinuousDecoder(params, config, **LLAMA_DECODER)
    gaps = LogitGaps(decoder)
    try:
        run = serve_requests(decoder, requests)
    finally:
        gaps.close()
    return run["done"], gaps.by_request(run["done"])


def phase_llama_dense() -> tuple:
    """The llama phase's 24 requests (1,344 tokens) through the dense slot
    cache (paged_kv False, the JAX default) at LLAMA_CUT_LAYERS of
    Llama-1B's layers: every request completes and no paged kernel
    launches; tokens/s, rounds, the cache's bytes, one round under the
    profiler; and at each request's first token that splits from the
    paged llama decoder's run at that depth under LogitGaps, that run's
    top-2 logit gap.  Returns that run's (tokens, gaps) for
    phase_llama_spec."""
    import numpy as np

    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = llama_1b(num_layers=LLAMA_CUT_LAYERS)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    decoder = ContinuousDecoder(params, config,
                                **{**LLAMA_DECODER, "paged_kv": False})
    torch.cuda.reset_peak_memory_stats()
    requests = llama_traffic(np.random.default_rng(0), config.vocab)
    # the main path's run: counts set to 0 just before, read just after
    zero_paged_counts()
    run = serve_requests(decoder, requests)
    launches = dict(P.launches)
    if any(launches.values()):
        raise AssertionError(f"the dense decoder launched the paged kernel "
                             f"{launches}")
    if max(run["t_caps"]) != 512:
        raise AssertionError(f"t_cap reached {max(run['t_caps'])}, not 512")
    stats = dict(decoder.stats)
    rng = np.random.default_rng(1)
    for i in range(16):
        decoder.submit(f"p{i}", rng.integers(0, config.vocab, 64).tolist(),
                       40, lambda *_: None)
    decoder.pump()                 # admits
    decoder.pump()                 # first decode round
    profile = profile_round(decoder, "llama dense decode")
    while not decoder.idle:
        decoder.pump()
    del decoder
    gap_tokens, gaps = reference_gaps(params, config, requests)
    record = {"phase": "llama_dense", "layers": config.num_layers,
              **served_record(run, stats, None, (gap_tokens, gaps)),
              "paged_launches": sum(launches.values()),
              "kv_cache_bytes": run["kv_bytes_final"]}
    emit(record)
    emit({"phase": "profile", **profile})
    return gap_tokens, gaps


def phase_llama_spec(gap_run: tuple) -> dict:
    """The llama phase's traffic through the paged decoder with
    speculate_k 2, then 4 (speculate_ngram 2), at llama_dense's depth
    and weights: every request completes, the paged kernel launches once
    per layer per verify step (at W = 3, then W = 5) and nothing else;
    the accept rate, tokens/s, round s, one round under the profiler,
    and `gap_run`'s top-2 gap where the tokens split from it (random
    weights: the accept rate measures the machinery, not a real-text
    win).  Returns the launches by k."""
    import numpy as np

    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = llama_1b(num_layers=LLAMA_CUT_LAYERS)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    requests = llama_traffic(np.random.default_rng(0), config.vocab)
    launches_by_k = {}
    for k in SPEC_KS:
        decoder = ContinuousDecoder(params, config, **LLAMA_DECODER,
                                    speculate_k=k,
                                    speculate_ngram=SPEC_NGRAM)
        torch.cuda.reset_peak_memory_stats()
        zero_paged_counts()
        run = serve_requests(decoder, requests)
        launches = dict(P.launches)
        stats = dict(decoder.stats)
        expected = {name: 0 for name in launches}
        expected["paged_decode_attention"] = \
            config.num_layers * stats["steps"]
        if launches != expected or not stats["steps"]:
            raise AssertionError(f"speculate_k {k}: paged launches "
                                 f"{launches} != {expected}")
        launches_by_k[k] = launches["paged_decode_attention"]
        rng = np.random.default_rng(1)
        for i in range(16):
            decoder.submit(f"p{i}", rng.integers(0, config.vocab,
                                                 64).tolist(), 40,
                           lambda *_: None)
        decoder.pump()
        decoder.pump()
        profile = profile_round(decoder, f"llama verify, speculate_k {k}")
        while not decoder.idle:
            decoder.pump()
        emit({"phase": "llama_spec", "speculate_k": k,
              "speculate_ngram": SPEC_NGRAM,
              "layers": config.num_layers,
              **served_record(run, stats, None, gap_run),
              "verify_width": k + 1,
              "paged_launches": launches["paged_decode_attention"],
              "paged_launches_expected": expected["paged_decode_attention"],
              "accept_rate": decoder.accept_rate(),
              "spec_proposed": stats["spec_proposed"],
              "spec_accepted": stats["spec_accepted"],
              "accepted_per_step": stats["accepted_per_step"]})
        emit({"phase": "profile", **profile})
        del decoder
    return launches_by_k


def phase_llama_spec_int8() -> dict:
    """The int8 phase's decoder and traffic (int8 pools, chunks of 64)
    with speculate_k 2, under torch's sync debug mode: every request
    completes, the folded int8 kernel launches 16 x verify steps (at W =
    3) and the dequantizing one 16 x extend dispatches, and no call
    synchronizes the stream beyond each round's one wait.  Returns the
    launches by variant."""
    import numpy as np

    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = llama_1b()
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    decoder = ContinuousDecoder(params, config, **LLAMA_INT8_DECODER,
                                speculate_k=2, speculate_ngram=SPEC_NGRAM)
    dispatches = count_extends(decoder)
    torch.cuda.reset_peak_memory_stats()
    requests = int8_traffic(np.random.default_rng(3), config.vocab)
    zero_paged_counts()
    run = serve_requests(decoder, requests, sync_debug=True)
    launches = dict(P.launches)
    stats = dict(decoder.stats)
    expected = {"paged_decode_attention": 0,
                "paged_decode_attention_int8_fold":
                    config.num_layers * stats["steps"],
                "paged_decode_attention_int8_dequant":
                    config.num_layers * dispatches[0]}
    if launches != expected or not dispatches[0]:
        raise AssertionError(f"paged kernel launches {launches} != "
                             f"{expected}")
    emit({"phase": "llama_spec_int8", **served_record(run, stats, None),
          "extend_dispatches": dispatches[0], "launches": launches,
          "stream_syncs": 0, "prefill_chunks": stats["prefill_chunks"],
          "accept_rate": decoder.accept_rate(),
          "spec_proposed": stats["spec_proposed"],
          "spec_accepted": stats["spec_accepted"]})
    return launches


def accepted_positions(decoder) -> list:
    """Record every token a speculative decoder delivers from past the
    first position of a verify block (an accepted draft's place) as
    (request id, index in its output, token), by wrapping
    _deliver_spec."""
    found = []
    deliver = decoder._deliver_spec

    def recording(emitted, emit_mask, occupied, num_steps):
        for slot in occupied:
            request = decoder._slots[slot]
            if request is None:
                continue
            index = len(request.generated)
            for step, position in zip(*emit_mask[:, slot, :].nonzero()):
                if position > 0:
                    found.append((request.request_id, index,
                                  int(emitted[step, slot, position])))
                index += 1
        return deliver(emitted, emit_mask, occupied, num_steps)

    decoder._deliver_spec = recording
    return found


def phase_decoder_f32() -> dict:
    """Full width at 2 layers in f32 (TF32 off): the dense decoder, the
    dense decoder with speculate_k 2 and the paged decoder with
    speculate_k 2 and 4 each give the tokens of llama_greedy_decode
    (phase_llama_f32's tie rule), with a mid-stream admit and an EOS
    that lands inside one of its own verify blocks: a first run of each
    speculative decoder without EOS finds a token it delivered from an
    accepted draft's place, first in its request, and that token is the
    decoder's EOS (the dense decoder, which has no verify block, takes
    the paged k = 4 decoder's).  Then the
    dense int8 chunked decoder on the card against itself on the CPU
    (llama_int8_f32's tie rule)."""
    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = dataclasses.replace(LLAMA_PRESETS["1b"], num_layers=2,
                                 dtype=torch.float32, max_seq_len=1024)
    check_1b(config)
    params = llama_init(torch.Generator(device="cuda").manual_seed(1),
                        config)
    rng = np.random.default_rng(6)
    motif = rng.integers(0, config.vocab, 8).tolist()
    prompts = {f"f{n}": rng.integers(0, config.vocab, n).tolist()
               for n in (20, 57, 100)}
    prompts["repeat"] = motif * 8              # 64 tokens, one bigram loop
    later = {"mid": rng.integers(0, config.vocab, 40).tolist()}
    max_new = 48

    def serve(options, eos=None, watch=None):
        decoder = ContinuousDecoder(params, config, **{
            **LLAMA_DECODER, "max_slots": 8, "eos_token": eos, **options},
            speculate_ngram=SPEC_NGRAM)
        seen = watch(decoder) if watch and decoder.speculate_k else []
        done = {}
        for rid, prompt in prompts.items():
            decoder.submit(rid, prompt, max_new,
                           lambda r, t: done.update({r: list(t)}))
        decoder.pump()
        for rid, prompt in later.items():
            decoder.submit(rid, prompt, max_new,
                           lambda r, t: done.update({r: list(t)}))
        while not decoder.idle:
            decoder.pump()
        if decoder.paged and decoder.pool.used_blocks():
            raise AssertionError("f32 run left pool blocks owned")
        return done, seen, decoder

    eos_by = {}
    for label, options in F32_DECODERS.items():
        if not options.get("speculate_k"):
            continue
        first_run, accepted, _ = serve(options, watch=accepted_positions)
        eos_by[label] = next((token for rid, index, token in accepted
                              if first_run[rid].index(token) == index), None)
        if eos_by[label] is None:
            raise AssertionError(f"{label}: no accepted draft to stop at "
                                 f"({len(accepted)} accepted)")
    eos_by["dense"] = eos_by["paged_spec4"]
    everything = {**prompts, **later}
    with torch.inference_mode():
        refs = {rid: llama_greedy_tokens(params, config, prompt, max_new)
                for rid, prompt in everything.items()}
    results = {}
    for label, options in F32_DECODERS.items():
        eos = eos_by[label]
        done, inside, decoder = serve(options, eos, watch=accepted_positions)
        ties, identical = [], 0
        for rid, prompt in everything.items():
            tie = stop_check(params, config, prompt, done[rid], refs[rid],
                             eos, f"{label} {rid}")
            identical += tie is None
            ties += [tie] if tie else []
        results[label] = {
            "eos": eos, "identical": identical, "ties": ties,
            "eos_inside_block": sum(token == eos for _, _, token in inside),
            "accept_rate": decoder.accept_rate()}
        if decoder.speculate_k and not results[label]["eos_inside_block"]:
            raise AssertionError(f"{label}: the EOS did not land inside a "
                                 f"verify block")
    record = {"phase": "decoder_f32", "requests": len(everything),
              "decoders": results,
              "dense_int8_card_against_cpu": int8_card_against_cpu(False)}
    emit(record)
    return record


def llama_greedy_tokens(params, config, prompt, max_new) -> list:
    from aiko_services_tpu_torch.models.llama import llama_greedy_decode
    return llama_greedy_decode(params, config, torch.tensor(
        [prompt], device=params.embed.table.device),
        max_tokens=max_new)[0].tolist()


def stop_check(params, config, prompt, got, ref, eos, label) -> dict | None:
    """got against the greedy reference `ref` cut at its first `eos` (the
    decoder strips the EOS); None when equal, the tie's record when the
    first difference's reference top-2 logit gap is under 1e-4; raises
    otherwise."""
    from aiko_services_tpu_torch.models.llama import llama_forward
    want = ref[:ref.index(eos)] if eos in ref else ref
    if got == want:
        return None
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    with torch.inference_mode():
        logits = llama_forward(params, config, torch.tensor(
            [prompt + ref[:i]], device=params.embed.table.device))[0, -1]
    top2 = torch.topk(logits, 2).values
    gap = (top2[0] - top2[1]).item()
    if gap >= 1e-4:
        raise AssertionError(f"{label}: tokens {got[i:i + 3]} != greedy "
                             f"{want[i:i + 3]} at step {i}, top-2 gap {gap}")
    return {"request": label, "step": i, "gap": gap}


def phase_agent_dense() -> dict:
    """The agent phase's conversation (8 streams x 3 turns, Llama-1B in
    bf16) through PE_LlamaAgent at `paged` false, the element's default:
    the dense decoder with dense prefix nodes.  Every frame completes,
    turns 2-3 admit through the cache, prefill + cached tokens = prompt
    tokens, hits copy rows (prefix_copy_bytes > 0, where paged hits
    alias), no paged kernel launches; the leases lapse and purge empties
    the cache."""
    import numpy as np

    from aiko_services_tpu_torch.event import settle_virtual
    from aiko_services_tpu_torch.ops import paged_attention as P

    parameters = {**AGENT_PARAMETERS, "paged": False}
    with agent_preset(dtype=torch.bfloat16) as config:
        check_1b(config)
        runtime, compute = host_runtime()
        engine = runtime.event
        texts = agent_texts(np.random.default_rng(AGENT_SEED))
        submitted = []

        def before_drive(agent):
            submit = agent.decoder.submit

            def recording(request_id, prompt, *args, **kwargs):
                submitted.append(len(prompt))
                return submit(request_id, prompt, *args, **kwargs)
            agent.decoder.submit = recording
            zero_paged_counts()

        timer = RoundTimer()
        try:
            pipeline, agent, frames, virtual_s, wall_s = conversation(
                runtime, texts, before_drive, parameters)
        finally:
            timer.close()
        torch.cuda.synchronize()
        launches = dict(P.launches)
    decoder, cache = agent.decoder, agent.prefix_cache
    stats, cache_stats = dict(decoder.stats), dict(cache.stats)
    failed = pipeline.recovery_stats["frames_failed"]
    if len(frames) != AGENT_STREAMS * AGENT_TURNS or failed:
        raise AssertionError(f"{len(frames)} agent frames, {failed} failed")
    for (stream_id, turn), frame in frames.items():
        if len(frame.swag["response_tokens"]) != \
                AGENT_PARAMETERS["max_tokens"]:
            raise AssertionError(f"agent frame {stream_id} turn {turn}")
    if decoder.paged or cache.paged or any(launches.values()):
        raise AssertionError(f"not the dense decoder: paged "
                             f"{decoder.paged}, launches {launches}")
    prompt_tokens = sum(submitted)
    if stats["prefix_admits"] < AGENT_MIN_PREFIX_ADMITS or \
            stats["tokens_prefill"] + cache_stats["hit_tokens"] != \
            prompt_tokens or not stats["prefix_copy_bytes"]:
        raise AssertionError(
            f"{stats['prefix_admits']} prefix admits, prefilled "
            f"{stats['tokens_prefill']} + cached {cache_stats['hit_tokens']}"
            f" of {prompt_tokens}, copied {stats['prefix_copy_bytes']} B")
    settle_virtual(engine, AGENT_PARAMETERS["session_lease"] + 1.0)
    table = agent._session_table
    pinned = sum(1 for node in cache._nodes.values() if node.refs)
    if len(table) or pinned:
        raise AssertionError(f"{len(table)} sessions and {pinned} pinned "
                             f"cache blocks after the leases lapsed")
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    resident = len(cache)
    evicted = cache.purge()
    if len(cache):
        raise AssertionError(f"{len(cache)} cache blocks after purge")
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    rounds = timer.rounds
    record = {
        "phase": "agent_dense", "frames": len(frames),
        "frames_failed": failed, "prompt_tokens": prompt_tokens,
        "tokens_prefill": stats["tokens_prefill"],
        "hit_tokens": cache_stats["hit_tokens"],
        "prefix_admits": stats["prefix_admits"],
        "prefix_copy_bytes": stats["prefix_copy_bytes"],
        "harvest_copy_bytes": stats["harvest_copy_bytes"],
        "decode_steps": stats["steps"],
        "prefill_chunks": stats["prefill_chunks"],
        "cache_blocks": resident, "evicted_by_purge": evicted,
        "paged_launches": sum(launches.values()),
        "kv_cache_bytes": decoder.kv_cache_bytes(),
        "virtual_s": virtual_s, "wall_s": wall_s, "rounds": len(rounds),
        "first_round_s": rounds[0],
        "steady_round_s": statistics.median(rounds[2:])}
    emit(record)
    return record


# -- text to speech, the audio elements, the MoE decoder --------------------

def tts_texts(rng, streams: int = TTS_STREAMS) -> dict:
    """{stream: [TTS_TEXTS texts]}: seeded words, 8-128 bytes each; the
    first stream's first text is TTS_LONG_BYTES long, so truncation at
    max_tokens binds."""
    def text(n):
        words = []
        while sum(len(w) + 1 for w in words) < n:
            words.append(AGENT_WORDS[int(rng.integers(len(AGENT_WORDS)))])
        return " ".join(words)[:n]
    texts = {f"t{s}": [text(int(rng.integers(8, 129)))
                       for _ in range(TTS_TEXTS)] for s in range(streams)}
    texts["t0"][0] = text(TTS_LONG_BYTES)
    return texts


def tts_definition(**parameters):
    """A one-element pipeline, (PE_NeuralTTS), at TTS_PARAMETERS plus
    `parameters`."""
    from aiko_services_tpu_torch.pipeline import parse_pipeline_definition
    return parse_pipeline_definition({
        "version": 0, "name": "p_tts", "runtime": "python",
        "graph": ["(PE_NeuralTTS)"],
        "parameters": {f"PE_NeuralTTS.{key}": value for key, value in
                       {**TTS_PARAMETERS, **parameters}.items()},
        "elements": [{"name": "PE_NeuralTTS", "input": [{"name": "text"}],
                      "output": [{"name": "audio"},
                                 {"name": "sample_rate"}]}]})


def speak(device, texts: dict, mesh=None, **parameters) -> tuple:
    """Every text through (PE_NeuralTTS) on `device` (None: the card;
    the runtime over `mesh` when given), text i of every stream posted
    before text i + 1.  Returns ({(stream, i): audio}, the element, the
    compute runtime, the runtime, the pipeline, wall s); the caller
    stops them (stop_pipeline)."""
    import numpy as np

    from aiko_services_tpu_torch.pipeline import Pipeline

    runtime, compute = host_runtime(device, mesh=mesh)
    engine = runtime.event
    pipeline = Pipeline(runtime, tts_definition(**parameters),
                        stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    for stream_id in texts:
        pipeline.create_stream(stream_id, lease_time=0)
    element = pipeline.graph.node("PE_NeuralTTS").element
    total = sum(len(t) for t in texts.values())
    start = time.perf_counter()
    for i in range(max(len(t) for t in texts.values())):
        for stream_id, stream_texts in texts.items():
            if i < len(stream_texts):
                pipeline.post("process_frame", stream_id,
                              {"text": stream_texts[i]})
    while len(done) < total:
        if time.perf_counter() - start > TTS_TIMEOUT_S:
            raise AssertionError(f"{len(done)} of {total} TTS frames in "
                                 f"{TTS_TIMEOUT_S} s")
        if not engine.step():
            engine.clock.advance(0.01)
    if device != "cpu":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    failed = pipeline.recovery_stats["frames_failed"]
    if failed:
        raise AssertionError(f"{failed} TTS frames failed")
    audio = {}
    for stream_id in texts:
        frames = sorted((f for f in done if f.stream_id == stream_id),
                        key=lambda f: f.frame_id)
        for i, frame in enumerate(frames):
            if frame.swag.get("sample_rate") != 16000:
                raise AssertionError(f"TTS frame {stream_id}:{i}: "
                                     f"{sorted(frame.swag)}")
            audio[(stream_id, i)] = np.asarray(frame.swag["audio"])
    return audio, element, compute, runtime, pipeline, wall_s


def stop_pipeline(runtime, compute, pipeline) -> None:
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    pipeline.stop()
    compute.stop()
    runtime.terminate()


def tts_tokens(element, texts: dict) -> tuple:
    """(keys in order, the element's collated [N, max_tokens] int32 token
    batch of every text) — the same ids the element submits."""
    import numpy as np

    keys = [(sid, i) for sid in texts for i in range(len(texts[sid]))]
    batch = np.zeros((len(keys), element.max_tokens), np.int32)
    for row, (sid, i) in enumerate(keys):
        ids = element.tokenizer.encode(texts[sid][i])[:element.max_tokens] \
            or [32]
        batch[row, :len(ids)] = ids
    return keys, batch


def tts_totals(element, tokens) -> tuple:
    """(mel [N, max_frames, n_mels], total frames [N]) of the element's
    model on its device."""
    from aiko_services_tpu_torch.models.tts import tts_forward
    mel, total = tts_forward(element.params, element.config,
                             torch.from_numpy(tokens).to(
                                 element.compute.device),
                             mesh=element.compute.sharding_mesh)
    return mel.float().cpu().numpy(), total.cpu().numpy()


def total_tolerance(total) -> float:
    return TTS_TIE + TTS_TOTAL_REL * abs(float(total))


def near_integer(total) -> bool:
    return abs(float(total) - round(float(total))) <= total_tolerance(total)


def check_tts_audio(audio: dict, keys, totals, row_samples: int) -> int:
    """Every waveform finite, of max(samples, 160) samples (samples =
    clip(ceil(total), 0, max_frames) x 160, within the synthesized row):
    a count one frame off passes only where the total lies within
    total_tolerance of an integer.  Returns those ties."""
    import numpy as np

    ties = 0
    for key, total in zip(keys, totals):
        wave = audio[key]
        frames = int(min(max(math.ceil(float(total)), 0), 1024))
        want = min(max(frames * 160, 160), row_samples)
        if wave.dtype != np.float32 or not np.all(np.isfinite(wave)):
            raise AssertionError(f"TTS {key}: not finite f32")
        if wave.size != want:
            if not near_integer(total) or abs(wave.size - want) != 160:
                raise AssertionError(f"TTS {key}: {wave.size} samples, "
                                     f"expected {want} (total {total})")
            ties += 1
    return ties


def tts_record(label, audio, element, compute, wall_s, texts, keys,
               totals, row_samples) -> dict:
    program = compute.programs[element._program]
    steady = [s for _, s in program.recent_service]
    return {"phase": label, "frames": len(audio), "wall_s": wall_s,
            "frames_per_s": len(audio) / wall_s,
            "batches": len(program.first_call_times) + len(steady),
            "first_call_s": program.first_call_times,
            "steady_batch_s": statistics.median(steady) if steady else None,
            "samples": sorted(int(a.size) for a in audio.values()),
            "audio_s": sum(a.size for a in audio.values()) / 16000.0,
            "row_samples": row_samples,
            "truncated_texts": sum(1 for sid, i in keys
                                   if len(element.tokenizer.encode(
                                       texts[sid][i])) >
                                   element.max_tokens),
            "length_ties": check_tts_audio(audio, keys, totals,
                                           row_samples)}


def profile_tts_batch(element, compute, texts: dict) -> dict:
    """One full batch (max_batch texts) submitted straight to the TTS
    program under torch.profiler."""
    program = compute.programs[element._program]
    payloads = [element.tokenizer.encode(t)[:element.max_tokens] or [32]
                for stream in texts.values() for t in stream]
    payloads = payloads[:program.scheduler.max_batch]
    got = []
    record = profile_batch(
        "tts", lambda: [compute.submit(element._program, "profile", ids,
                                       len(ids), lambda _s, r: got.append(r))
                        for ids in payloads], program.scheduler)
    if len(got) != len(payloads) or \
            any(isinstance(r, Exception) for r in got):
        raise AssertionError(f"profiled TTS batch: {len(got)} results")
    record["launches_per_batch"] = record["device_launches"]
    return record


def write_vocoder_npz(directory: str, device) -> str:
    """A seeded base-preset vocoder checkpoint (flat npz) in `directory`."""
    from aiko_services_tpu_torch.bridge import save_flat_npz
    from aiko_services_tpu_torch.models.vocoder import (VOCODER_PRESETS,
                                                        vocoder_init)
    path = os.path.join(directory, "vocoder_base.npz")
    save_flat_npz(vocoder_init(
        torch.Generator(device=device).manual_seed(TTS_SEED),
        VOCODER_PRESETS["base"], device=device), path)
    return path


def phase_tts(directory: str) -> dict:
    """PE_NeuralTTS at preset base (dim 128, 4 layers, max_tokens 128,
    max_frames 1024, f32), batched, max_batch 16, Griffin-Lim 32 rounds,
    on a ComputeRuntime: one warm-up batch, then TTS_STREAMS x TTS_TEXTS
    seeded texts; then the same drive with a seeded base vocoder
    checkpoint.  No attention kernel launches (S = 128 < FLASH_MIN_SEQ).
    Returns the Griffin-Lim element's weights path and the vocoder's."""
    import numpy as np

    from aiko_services_tpu_torch.bridge import save_flat_npz

    torch.cuda.reset_peak_memory_stats()
    texts = tts_texts(np.random.default_rng(TTS_SEED))
    warm = {"warm": [t for stream in list(texts.values())[:4]
                     for t in stream][:16]}
    vocoder = write_vocoder_npz(directory, "cuda")
    records, weights = [], None
    for label, parameters in (("tts", {}),
                              ("tts_vocoder", {"vocoder_weights": vocoder,
                                               "vocoder_preset": "base"})):
        pipeline_parts = None
        try:
            # warm-up: one batch carries cuFFT plans and cuDNN choices
            _, element, compute_w, runtime_w, pipeline_w, _ = speak(
                None, warm, **parameters)
            stop_pipeline(runtime_w, compute_w, pipeline_w)
            zero_attention_counts()
            audio, element, compute, runtime, pipeline, wall_s = speak(
                None, texts, **parameters)
            counts = attention_counts()
            pipeline_parts = (runtime, compute, pipeline)
            config = element.config
            if (config.dim, config.num_layers, config.max_tokens,
                    config.max_frames, config.dtype) != \
                    (128, 4, 128, 1024, torch.float32) or \
                    element.max_tokens != 128 or \
                    compute.programs[element._program].scheduler.max_batch \
                    != 16:
                raise AssertionError(f"not the base preset: {config}")
            if any(counts.values()):
                raise AssertionError(f"{label}: attention kernels "
                                     f"launched {counts}")
            if (element.vocoder is None) != (label == "tts"):
                raise AssertionError(f"{label}: vocoder {element.vocoder}")
            keys, tokens = tts_tokens(element, texts)
            _, totals = tts_totals(element, tokens)
            row = 160 * (config.max_frames - (label == "tts"))
            record = tts_record(label, audio, element, compute, wall_s,
                                texts, keys, totals, row)
            record["profile"] = profile_tts_batch(element, compute, texts)
            record["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if label == "tts":
                weights = os.path.join(directory, "tts_base.npz")
                save_flat_npz(element.params, weights)
        finally:
            if pipeline_parts is not None:
                stop_pipeline(*pipeline_parts)
        emit(record)
        records.append(record)
    return {"weights": weights, "vocoder": vocoder, "records": records}


def stft_magnitude(wave):
    import numpy as np

    from aiko_services_tpu_torch.ops.audio import stft_complex
    return stft_complex(torch.from_numpy(np.asarray(
        wave, np.float32)[None].copy())).abs()[0].numpy()


def rel_l2(got, want) -> float:
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def phase_tts_f32(paths: dict) -> dict:
    """The tts phase's weights (flat npz) and TTS_F32_STREAMS x
    TTS_TEXTS of its texts through PE_NeuralTTS on the card and on the
    CPU port, with Griffin-Lim and with the vocoder: totals within
    total_tolerance, mel within TTS_MEL_REL_L2, equal sample counts (one
    frame off only at a tie), Griffin-Lim by the STFT magnitude within
    TTS_GL_STFT_REL_L2 and the vocoder's waveform within
    TTS_VOCODER_REL_L2."""
    import numpy as np

    texts = tts_texts(np.random.default_rng(TTS_SEED))
    texts = dict(list(texts.items())[:TTS_F32_STREAMS])
    record = {"phase": "tts_f32", "frames": 0, "ties": 0}
    for label, parameters in (
            ("griffin_lim", {"weights": paths["weights"]}),
            ("vocoder", {"weights": paths["weights"],
                         "vocoder_weights": paths["vocoder"],
                         "vocoder_preset": "base"})):
        runs = {}
        for device in ("cuda", "cpu"):
            audio, element, compute, runtime, pipeline, wall_s = speak(
                None if device == "cuda" else "cpu", texts, **parameters)
            keys, tokens = tts_tokens(element, texts)
            mel, totals = tts_totals(element, tokens)
            runs[device] = (audio, mel, totals, wall_s)
            stop_pipeline(runtime, compute, pipeline)
        (card, card_mel, card_totals, card_s), \
            (cpu, cpu_mel, cpu_totals, cpu_s) = runs["cuda"], runs["cpu"]
        total_err = float(np.max(np.abs(card_totals - cpu_totals)))
        mel_err = rel_l2(card_mel, cpu_mel)
        if any(abs(a - b) > total_tolerance(b)
               for a, b in zip(card_totals, cpu_totals)) or \
                mel_err > TTS_MEL_REL_L2:
            raise AssertionError(f"tts_f32 {label}: totals {total_err}, "
                                 f"mel rel-L2 {mel_err}")
        wave_errs = []
        for key, total in zip(keys, cpu_totals):
            a, b = card[key], cpu[key]
            if a.size != b.size:
                if not near_integer(total) or abs(a.size - b.size) != 160:
                    raise AssertionError(f"tts_f32 {label} {key}: {a.size} "
                                         f"/ {b.size} samples")
                record["ties"] += 1
                continue
            err = rel_l2(stft_magnitude(a), stft_magnitude(b)) \
                if label == "griffin_lim" else rel_l2(a, b)
            wave_errs.append(err)
        limit = TTS_GL_STFT_REL_L2 if label == "griffin_lim" \
            else TTS_VOCODER_REL_L2
        if max(wave_errs) > limit:
            raise AssertionError(f"tts_f32 {label}: rel-L2 "
                                 f"{max(wave_errs)} > {limit}")
        record["frames"] += len(card)
        record[label] = {"total_max_abs": total_err, "mel_rel_l2": mel_err,
                         "audio_rel_l2_max": max(wave_errs),
                         "audio_measure": "stft magnitude"
                         if label == "griffin_lim" else "waveform",
                         "limit": limit, "card_s": card_s, "cpu_s": cpu_s}
    emit(record)
    return record


def classify_on(frames: dict, mesh=None) -> tuple:
    """`frames` through classify's pipeline on the card (its runtime over
    `mesh` when given): ({key: (class id, confidence)}, the element's
    runtime mesh, attention launches)."""
    from aiko_services_tpu_torch.pipeline import Pipeline

    runtime, compute = host_runtime(mesh=mesh)
    pipeline = Pipeline(runtime, classify_definition(), stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    for stream in sorted({stream for stream, _ in frames}):
        pipeline.create_stream(stream, lease_time=0)
    element = pipeline.graph.node("PE_ImageClassify").element
    program = compute.programs[element._program]
    zero_attention_counts()
    drive_frames(runtime.event, pipeline, done, frames, program, 120.0)
    torch.cuda.synchronize()
    launches = attention_counts()
    if pipeline.recovery_stats["frames_failed"]:
        raise AssertionError("classify frames failed")
    got = {(f.stream_id, f.frame_id): (f.swag["class_id"],
                                       f.swag["confidence"]) for f in done}
    placed_on = compute.sharding_mesh
    stop_pipeline(runtime, compute, pipeline)
    return got, placed_on, launches


def phase_elements_mesh() -> int:
    """PE_NeuralTTS (base, Griffin-Lim) and PE_ImageClassify (ResNet-18 at
    224) each on a ComputeRuntime over create_mesh({"model": 1}), placed
    by tts_axes and resnet_axes through the runtime and run with its
    mesh, against the same elements without a mesh, on ELEMENTS_MESH's
    short drives of the tts and classify phases' inputs: equal sample
    counts, totals, mel and Griffin-Lim audio within tts_f32's limits,
    class ids equal and confidences within CLASSIFY_TOL, and no
    attention launch.  Returns the attention launches of the mesh
    runs."""
    import numpy as np

    from aiko_services_tpu_torch.parallel import create_mesh

    mesh = create_mesh({"model": 1})
    start = time.perf_counter()
    texts = tts_texts(np.random.default_rng(TTS_SEED),
                      streams=ELEMENTS_MESH["tts_streams"])
    runs, launches = {}, 0
    for label, on in (("one", None), ("mesh", mesh)):
        zero_attention_counts()
        audio, element, compute, runtime, pipeline, _ = speak(
            None, texts, mesh=on)
        counts = attention_counts()
        if compute.sharding_mesh is not on:
            raise AssertionError("the TTS runtime is not on the mesh")
        _, tokens = tts_tokens(element, texts)
        mel, total = tts_totals(element, tokens)
        stop_pipeline(runtime, compute, pipeline)
        runs[label] = (audio, mel, total)
        if any(counts.values()):
            raise AssertionError(f"elements_mesh tts: attention {counts}")
        if on is not None:
            launches += sum(counts.values())
    (audio, mel, total), (audio_m, mel_m, total_m) = runs["one"], \
        runs["mesh"]
    tts = {"texts": len(audio),
           "samples_equal": all(audio[key].size == audio_m[key].size
                                for key in audio),
           "audio_equal": all(np.array_equal(audio[key], audio_m[key])
                              for key in audio),
           "max_total_err": float(np.abs(total - total_m).max()),
           "mel_rel_l2": rel_l2(mel_m, mel),
           "gl_stft_rel_l2": max(rel_l2(stft_magnitude(audio_m[key]),
                                        stft_magnitude(audio[key]))
                                 for key in audio)}
    if not tts["samples_equal"] or any(
            abs(a - b) > total_tolerance(b) for a, b in
            zip(total_m, total)) or tts["mel_rel_l2"] > TTS_MEL_REL_L2 or \
            tts["gl_stft_rel_l2"] > TTS_GL_STFT_REL_L2:
        raise AssertionError(f"elements_mesh tts on the mesh: {tts}")
    frames = classify_inputs(ELEMENTS_MESH["classify_frames"])
    got, _, counts = classify_on(frames)
    got_m, placed_on, counts_m = classify_on(frames, mesh)
    if placed_on is not mesh or any(counts.values()) or \
            any(counts_m.values()):
        raise AssertionError(f"elements_mesh classify: mesh {placed_on}, "
                             f"attention {counts} / {counts_m}")
    launches += sum(counts_m.values())
    classify = {"frames": len(got_m),
                "ids_equal": all(got_m[key][0] == got[key][0]
                                 for key in got),
                "max_confidence_err": max(abs(got_m[key][1] - got[key][1])
                                          for key in got)}
    if sorted(got_m) != sorted(frames) or not classify["ids_equal"] or \
            classify["max_confidence_err"] > CLASSIFY_TOL:
        raise AssertionError(f"elements_mesh classify on the mesh: "
                             f"{classify}")
    emit({"phase": "elements_mesh", "mesh": {"model": 1}, "tts": tts,
          "classify": classify, "attention_launches": launches,
          "wall_s": time.perf_counter() - start})
    return launches


def phase_media() -> dict:
    """PE_MicrophoneSim → PE_FFT → PE_AudioFilter → PE_AudioResampler and
    PE_MicrophoneSim → PE_FFT → PE_GraphXY on the port's host plane: the
    FFT runs on the card (every sample batch crosses to it), and its
    magnitudes equal np.fft.rfft's within MEDIA_FFT_REL."""
    import numpy as np

    from aiko_services_tpu_torch.elements import audio as audio_module
    from aiko_services_tpu_torch.pipeline import (Pipeline,
                                                  parse_pipeline_definition)

    def element(name, inputs, outputs, parameters=None):
        return {"name": name, "input": [{"name": n} for n in inputs],
                "output": [{"name": n} for n in outputs],
                "parameters": parameters or {}}

    source = element("PE_MicrophoneSim", [], ["audio"],
                     {"chunk_seconds": MEDIA_CHUNK_S, "limit": MEDIA_CHUNKS,
                      "frequency": 440.0})
    fft = element("PE_FFT", ["audio"], ["frequencies", "magnitudes"])
    graphs = {
        "bands": ("(PE_MicrophoneSim (PE_FFT (PE_AudioFilter "
                  "PE_AudioResampler)))",
                  [element("PE_AudioFilter", ["frequencies", "magnitudes"],
                           ["frequencies", "magnitudes"],
                           {"low_hz": 100.0, "high_hz": 2000.0}),
                   element("PE_AudioResampler",
                           ["frequencies", "magnitudes"], ["bands"],
                           {"band_count": 8})]),
        "graph_xy": ("(PE_MicrophoneSim (PE_FFT (PE_GraphXY)))",
                     [element("PE_GraphXY", ["frequencies", "magnitudes"],
                              ["image"], {"width": 320, "height": 160})])}
    devices = []
    host_to = audio_module._host_to

    def recording(device, array):
        tensor = host_to(device, array)
        devices.append(tensor.device.type)
        return tensor

    audio_module._host_to = recording
    record = {"phase": "media"}
    try:
        for name, (graph, rest) in graphs.items():
            runtime, compute = host_runtime()
            engine = runtime.event
            pipeline = Pipeline(runtime, parse_pipeline_definition({
                "version": 0, "name": f"p_{name}", "runtime": "python",
                "graph": [graph], "elements": [source, fft] + rest}),
                stream_lease_time=0)
            done = []
            pipeline.add_frame_handler(done.append)
            start = time.perf_counter()
            pipeline.create_stream("s1", lease_time=0)
            while len(done) < MEDIA_CHUNKS and engine.clock.now() < 60.0:
                while engine.step():
                    pass
                engine.clock.advance(MEDIA_CHUNK_S)
            wall_s = time.perf_counter() - start
            if len(done) != MEDIA_CHUNKS or \
                    pipeline.recovery_stats["frames_failed"]:
                raise AssertionError(f"media {name}: {len(done)} of "
                                     f"{MEDIA_CHUNKS} frames")
            errors = []
            for frame in done:
                swag = frame.swag
                # an element's output name, not a metric family
                if name == "bands":  # graft: disable=lint-metric-drift
                    bands = np.asarray(swag["bands"])
                    if bands.shape != (8,) or int(np.argmax(bands)) != 0:
                        raise AssertionError(f"media bands {bands}")
                    continue
                want = np.abs(np.fft.rfft(np.asarray(swag["audio"],
                                                     np.float64)))
                got = np.asarray(swag["magnitudes"], np.float64)
                errors.append(float(np.max(np.abs(got - want)) /
                                    np.max(want)))
                image = np.asarray(swag["image"])
                if image.shape != (160, 320, 3) or not image.any():
                    raise AssertionError(f"media raster {image.shape}")
            if errors and max(errors) > MEDIA_FFT_REL:
                raise AssertionError(f"media FFT rel {max(errors)} > "
                                     f"{MEDIA_FFT_REL}")
            record[name] = {"frames": len(done), "wall_s": wall_s,
                            "fft_rel_err_max": max(errors) if errors
                            else None}
            stop_pipeline(runtime, compute, pipeline)
    finally:
        audio_module._host_to = host_to
    if not devices or set(devices) != {"cuda"}:
        raise AssertionError(f"PE_FFT ran on {collections.Counter(devices)}")
    record["fft_calls_on_card"] = len(devices)
    emit(record)
    return record


def moe_8x1b(**changes):
    """The 8x1b preset (Llama-1B's widths, 8 experts of 8192, top 2) in
    bf16 at max_seq_len 1024, with `changes`."""
    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS
    config = dataclasses.replace(LLAMA_PRESETS["8x1b"], **{
        "dtype": torch.bfloat16, "max_seq_len": 1024, **changes})
    check_1b(config)
    if (config.num_experts, config.top_k) != (8, 2):
        raise AssertionError(f"not the 8x1b preset: {config}")
    return config


def phase_llama_moe() -> int:
    """LLAMA_MOE_REQUESTS of the llama phase's requests (16 slots, 16
    steps per sync) through the paged decoder serving 8x1b at full width
    in bf16, seeded
    random weights: every request completes, the pool drains, the paged
    kernel launches 16 x the decode steps and the steps equal
    LLAMA_MOE_STEPS; tokens/s, rounds, dropped assignments per round and
    one round under the profiler.  The model is freed before returning
    the paged kernel's launches."""
    import gc

    import numpy as np

    from aiko_services_tpu_torch.models import moe
    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = moe_8x1b()
    if config.num_layers != 16:
        raise AssertionError(f"not 16 layers: {config}")
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    params = llama_init(torch.Generator(device="cuda").manual_seed(3),
                        config)
    decoder = ContinuousDecoder(params, config, **LLAMA_DECODER)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    expert_bytes = sum(p.numel() * p.element_size()
                       for name, p in params.named_parameters()
                       if ".moe.w_" in name)
    requests = llama_traffic(np.random.default_rng(0), config.vocab)[
        1:1 + LLAMA_MOE_REQUESTS]
    # each FFN call's dropped assignments (a device count), grouped by
    # round: the list's length after every pump
    marks, pump = [], decoder.pump

    def marked():
        pump()
        marks.append(len(moe.drop_counts))

    decoder.pump = marked
    moe.drop_counts = []
    # the main path's run: counts set to 0 just before, read just after
    zero_paged_counts()
    try:
        run = serve_requests(decoder, requests)
        launches = P.launches["paged_decode_attention"]
        drops = torch.stack(moe.drop_counts).cpu().tolist()
    finally:
        decoder.pump = pump
        moe.drop_counts = None
    stats = dict(decoder.stats)
    if launches != config.num_layers * stats["steps"] or \
            stats["steps"] != LLAMA_MOE_STEPS:
        raise AssertionError(f"paged launches {launches}, decode steps "
                             f"{stats['steps']} (predicted "
                             f"{LLAMA_MOE_STEPS})")
    per_round = [int(sum(drops[a:b])) for a, b in
                 zip([0] + marks[:-1], marks)]
    generated = sum(len(tokens) for tokens in run["done"].values())
    rng = np.random.default_rng(1)
    for i in range(16):
        decoder.submit(f"p{i}", rng.integers(0, config.vocab, 64).tolist(),
                       40, lambda *_: None)
    decoder.pump()                 # admits
    decoder.pump()                 # first decode round
    profile = profile_round(decoder, "moe decode")
    while not decoder.idle:
        decoder.pump()
    record = {"phase": "llama_moe", "requests": len(run["done"]),
              "tokens": generated, "setup_s": setup_s,
              "wall_s": run["wall_s"],
              "tokens_per_s": generated / run["wall_s"],
              "rounds": len(run["round_s"]),
              "first_round_s": run["round_s"][0],
              "steady_round_s": statistics.median(run["round_s"][2:]),
              "steps": stats["steps"], "paged_launches": launches,
              "paged_launches_expected": 16 * LLAMA_MOE_STEPS,
              "dropped_assignments": sum(per_round),
              "dropped_per_round": per_round,
              "moe_calls": len(drops),
              "weight_gb": weight_bytes / 1e9,
              "expert_gb": expert_bytes / 1e9,
              "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
              "profile": profile,
              "sample_tokens": {rid: run["done"][rid][:6]
                                for rid in ("r0", "r1")}}
    emit(record)
    del decoder, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_moe(params, config, device, prompts, max_new) -> tuple:
    """(tokens by request, [top-1 logit, top-2 gap] per emitted token by
    request, the router boundary gap behind each by request) of the
    paged decoder with one slot per request."""
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    decoder = ContinuousDecoder(params, config, device=device, **{
        **LLAMA_DECODER, "max_slots": len(prompts)})
    gaps = LogitGaps(decoder, router=True)
    done = {}
    try:
        for rid, prompt in prompts.items():
            decoder.submit(rid, prompt, max_new,
                           lambda r, t: done.update({r: list(t)}))
        requests = list(decoder._pending)
        while not decoder.idle:
            decoder.pump()
    finally:
        gaps.close()
    if decoder.pool.used_blocks() != 0:
        raise AssertionError("MoE f32 run left pool blocks owned")
    return (done, {r.request_id: gaps.by_slot[r.slot] for r in requests},
            {r.request_id: gaps.router_by_slot[r.slot] for r in requests})


def phase_llama_moe_f32() -> dict:
    """8x1b at full width, 2 layers, f32: (1) the paged decoder with 16
    slots (capacity 5 an expert at each decode step) on the card against
    the same decoder on the CPU, a first split passing only at a CPU
    top-2 logit gap under MOE_LOGIT_TIE or a router top-k boundary gap
    under MOE_ROUTER_TIE in the program that emitted it; (2) with top_k ==
    num_experts (no drops) the decoder's tokens against
    llama_greedy_decode, a split passing only under MOE_LOGIT_TIE."""
    import copy

    import numpy as np

    from aiko_services_tpu_torch.models.llama import (
        llama_forward, llama_greedy_decode, llama_init)
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = moe_8x1b(num_layers=2, dtype=torch.float32)
    params = llama_init(torch.Generator(device="cuda").manual_seed(4),
                        config)
    cpu_params = copy.deepcopy(params).cpu()
    rng = np.random.default_rng(6)
    prompts = {f"m{i}": rng.integers(0, config.vocab,
                                     int(rng.integers(16, 65))).tolist()
               for i in range(MOE_F32_REQUESTS)}
    start = time.perf_counter()
    got, _, _ = serve_moe(params, config, "cuda", prompts, MOE_F32_NEW)
    card_s = time.perf_counter() - start
    start = time.perf_counter()
    with torch.inference_mode():
        ref, cpu_gaps, cpu_router = serve_moe(cpu_params, config, "cpu",
                                              prompts, MOE_F32_NEW)
    cpu_s = time.perf_counter() - start
    del cpu_params
    ties, identical = [], 0
    for rid in prompts:
        if len(got[rid]) != MOE_F32_NEW or len(ref[rid]) != MOE_F32_NEW:
            raise AssertionError(f"MoE f32 request {rid}: {len(got[rid])} "
                                 f"/ {len(ref[rid])} tokens")
        i = next((j for j, (a, b) in enumerate(zip(got[rid], ref[rid]))
                  if a != b), None)
        if i is None:
            identical += 1
            continue
        gap, router = cpu_gaps[rid][i][1], cpu_router[rid][i]
        if gap >= MOE_LOGIT_TIE and router >= MOE_ROUTER_TIE:
            raise AssertionError(
                f"MoE f32 request {rid}: card token {got[rid][i]} != CPU "
                f"{ref[rid][i]} at step {i}, CPU top-2 gap {gap}, router "
                f"gap {router}")
        ties.append({"request": rid, "step": i, "gap": gap,
                     "router_gap": router})
    # (2) top_k == num_experts: no assignment drops, so a request's
    # tokens do not depend on the rows beside it
    dense = dataclasses.replace(config, top_k=config.num_experts)
    decoder = ContinuousDecoder(params, dense, **{**LLAMA_DECODER,
                                                  "max_slots": 4})
    greedy = dict(list(prompts.items())[:4])
    done = {}
    for rid, prompt in greedy.items():
        decoder.submit(rid, prompt, MOE_F32_NEW,
                       lambda r, t: done.update({r: list(t)}))
    while not decoder.idle:
        decoder.pump()
    greedy_ties, greedy_identical = [], 0
    device = params.embed.table.device
    with torch.inference_mode():
        for rid, prompt in greedy.items():
            want = llama_greedy_decode(
                params, dense, torch.tensor([prompt], device=device),
                max_tokens=MOE_F32_NEW)[0].tolist()
            if done[rid] == want:
                greedy_identical += 1
                continue
            i = next(j for j, (a, b) in enumerate(zip(done[rid], want))
                     if a != b)
            logits = llama_forward(params, dense, torch.tensor(
                [prompt + want[:i]], device=device))[0, -1]
            top2 = torch.topk(logits, 2).values
            gap = float(top2[0] - top2[1])
            if gap >= MOE_LOGIT_TIE:
                raise AssertionError(
                    f"MoE top-{dense.top_k} request {rid}: decoder token "
                    f"{done[rid][i]} != greedy {want[i]} at step {i}, "
                    f"top-2 gap {gap}")
            greedy_ties.append({"request": rid, "step": i, "gap": gap})
    record = {"phase": "llama_moe_f32", "requests": len(prompts),
              "identical": identical, "ties": ties,
              "tie_limits": [MOE_LOGIT_TIE, MOE_ROUTER_TIE],
              "min_cpu_gap": min(g for rid in prompts
                                 for _, g in cpu_gaps[rid]),
              "min_cpu_router_gap": min(g for rid in prompts
                                        for g in cpu_router[rid]),
              "card_s": card_s, "cpu_s": cpu_s,
              "all_experts_identical": greedy_identical,
              "all_experts_ties": greedy_ties}
    emit(record)
    return record


@contextlib.contextmanager
def sync_watch(arm: bool = True):
    """torch's sync debug mode ("warn") over the block: yields a Counter
    that holds, after the block, each call that synchronized the stream,
    by the innermost frame of this repo on the stack at the warning
    (file:line -> calls).  The decoder's one wait a round, on the event
    behind its device-to-host copy, is not one of them.  With arm False
    the caller sets the mode inside the block (after its set-up)."""
    import traceback

    syncs = collections.Counter()
    root = os.path.dirname(os.path.abspath(__file__))
    shown = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        # torch's warning at each synchronizing call ("... called a
        # synchronizing CUDA operation"), not set_sync_debug_mode's own
        # note that the mode is a prototype
        if "called a synchronizing" not in str(message):
            return
        frames = [frame for frame in traceback.extract_stack()[:-1]
                  if frame.filename.startswith(root)]
        where = frames[-1] if frames else None
        syncs[f"{os.path.basename(filename)}:{lineno} from "
              f"{os.path.relpath(where.filename, root)}:{where.lineno}"
              if where else f"{os.path.basename(filename)}:{lineno}"] += 1

    if arm:
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            yield syncs
    finally:
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = shown


def tiered_parameters(config) -> dict:
    """AGENT_PARAMETERS with the host tier and a prefix cache of
    AGENT_TIERED_BLOCKS blocks of `config`."""
    itemsize = torch.empty((), dtype=config.dtype).element_size()
    block_nbytes = (2 * config.num_layers * config.num_kv_heads *
                    config.head_dim * itemsize *
                    AGENT_PARAMETERS["prefix_block"])
    return {**AGENT_PARAMETERS, "host_kv_mb": AGENT_TIERED_HOST_MB,
            "prefix_cache_mb": AGENT_TIERED_BLOCKS * block_nbytes /
            (1 << 20)}


def demote_between_turns(agents: list):
    """conversation's between_turns for the tiered phases: every live
    session of the element (agents[0], set in before_drive) demotes its
    chain to the host tier; the table keeps the histories."""
    def demote(_turn):
        cache = agents[0].prefix_cache
        cache.demote_sessions(cache.sessions())
    return demote


class TierAudit:
    """A KV memory ledger on a tiered decoder, audited after every pump
    round, and the blocks each session demotion moved to the host tier,
    by session.  ContinuousDecoder.pump and PrefixKVCache.demote_sessions
    are wrapped at their classes (the element binds them as callbacks
    when its first stream opens, before bind()); after each round of the
    bound decoder the ledger must conserve: device bytes = the pool's
    used blocks x block bytes, host bytes = the store's (0 without a
    host tier), no auditor finding.  close() restores both classes."""

    def __init__(self):
        from aiko_services_tpu_torch.observe.ledger import KVMemoryLedger
        from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                     PrefixKVCache)
        self.ledger = KVMemoryLedger(name="smoke_tier")
        self.decoder = None
        self.rounds, self.failures = 0, []
        self.demotions = collections.Counter()
        self._saved = ((ContinuousDecoder, "pump", ContinuousDecoder.pump),
                       (PrefixKVCache, "demote_sessions",
                        PrefixKVCache.demote_sessions))
        audit = self
        pump, demote = self._saved[0][2], self._saved[1][2]

        def audited(target):
            pump(target)
            if target is audit.decoder:
                audit.check(target)

        def demote_each(cache, pairs):
            if audit.decoder is None or \
                    cache is not audit.decoder.prefix_cache:
                return demote(cache, pairs)
            moved = 0
            for pair in list(pairs):
                blocks = demote(cache, [pair])
                audit.demotions[pair[1]] += blocks
                moved += blocks
            return moved

        ContinuousDecoder.pump = audited
        PrefixKVCache.demote_sessions = demote_each

    def bind(self, decoder) -> None:
        self.decoder = decoder
        decoder.attach_ledger(self.ledger)

    def check(self, decoder) -> None:
        self.rounds += 1
        pool, store = decoder.pool, decoder.prefix_cache.host_store
        found = self.ledger.audit()
        device = self.ledger.device_bytes()
        host = store.bytes_used if store is not None else 0
        if found or device != pool.used_blocks() * pool.block_nbytes or \
                self.ledger.host_bytes() != host:
            self.failures.append({
                "round": self.rounds, "found": found, "device": device,
                "pool": pool.used_blocks() * pool.block_nbytes,
                "host": self.ledger.host_bytes(), "store": host})

    def close(self) -> None:
        for owner, name, method in self._saved:
            setattr(owner, name, method)


def promote_and_purge(cache, histories: dict) -> int:
    """Promote every conversation's host-tier chain back (promote_for on
    its whole history, the cache's byte budget lifted so no promotion
    evicts another), then purge the device tier without demotion:
    returns the blocks promoted; both tiers are then empty."""
    cache.max_bytes = None
    promoted = sum(cache.promote_for("default", history)
                   for history in histories.values()) // \
        cache.block_tokens
    cache.purge(demote=False)
    return promoted


def phase_agent_tiered() -> dict:
    """The agent phase's conversation with a host KV tier: 8 streams x 3
    turns through PE_LlamaAgent (Llama-1B, bf16, paged, sessions) under
    torch's sync debug mode, a prefix cache of AGENT_TIERED_BLOCKS blocks
    forcing every stream's chain to pinned host memory between its turns
    and back.  Returns the paged kernel's launches by path."""
    import numpy as np

    from aiko_services_tpu_torch.event import settle_virtual
    from aiko_services_tpu_torch.observe.ledger import assert_ledger_clean
    from aiko_services_tpu_torch.ops import paged_attention as P

    with agent_preset(dtype=torch.bfloat16) as config:
        check_1b(config)
        if config.num_layers != 16:
            raise AssertionError(f"not 16 layers: {config}")
        parameters = tiered_parameters(config)
        runtime, compute = host_runtime()
        engine = runtime.event
        texts = agent_texts(np.random.default_rng(AGENT_SEED))
        extends, submitted, agents = [], {}, []
        audit = TierAudit()

        def before_drive(agent):
            agents.append(agent)
            extends.append(count_extend_launches(agent.decoder))
            audit.bind(agent.decoder)
            submit = agent.decoder.submit

            def recording(request_id, prompt, *args, **kwargs):
                submitted[request_id] = list(prompt)
                return submit(request_id, prompt, *args, **kwargs)
            agent.decoder.submit = recording
            # the main path's run: counts set to 0 just before
            for name in P.launches:
                P.launches[name] = 0
            torch.cuda.set_sync_debug_mode("warn")

        timer = RoundTimer()
        try:
            with sync_watch(arm=False) as syncs:
                pipeline, agent, frames, virtual_s, wall_s = conversation(
                    runtime, texts, before_drive, parameters,
                    demote_between_turns(agents))
        finally:
            timer.close()
        torch.cuda.synchronize()
        launches = dict(P.launches)
    decoder, cache = agent.decoder, agent.prefix_cache
    store, promoter = cache.host_store, cache.promoter
    stats, cache_stats = dict(decoder.stats), dict(cache.stats)
    extend_dispatches, extend_launches = extends[0]
    decode_launches = launches["paged_decode_attention"] - extend_launches
    if syncs:
        raise AssertionError(f"the tiered agent synchronized the stream "
                             f"beyond its one wait a round: {dict(syncs)}")
    failed = pipeline.recovery_stats["frames_failed"]
    if len(frames) != AGENT_STREAMS * AGENT_TURNS or failed:
        raise AssertionError(f"{len(frames)} agent frames, {failed} failed")
    for (stream_id, turn), frame in frames.items():
        tokens = frame.swag["response_tokens"]
        if len(tokens) != AGENT_PARAMETERS["max_tokens"] or not all(
                0 <= t < config.vocab for t in tokens):
            raise AssertionError(f"tiered agent frame {stream_id} turn "
                                 f"{turn}: {len(tokens)} tokens")
    expected = {"decode": config.num_layers * AGENT_TIERED_DECODE_STEPS,
                "extend": config.num_layers * AGENT_TIERED_EXTEND_DISPATCHES}
    measured = {"decode": decode_launches, "extend": extend_launches}
    if measured != expected or \
            stats["steps"] != AGENT_TIERED_DECODE_STEPS or \
            extend_dispatches != AGENT_TIERED_EXTEND_DISPATCHES or \
            launches["paged_decode_attention_int8_fold"] or \
            launches["paged_decode_attention_int8_dequant"]:
        raise AssertionError(
            f"tiered agent paged launches {measured} != {expected} "
            f"({stats['steps']} decode steps, {extend_dispatches} extend "
            f"dispatches), all {launches}")
    prompt_tokens = sum(len(p) for p in submitted.values())
    if stats["tokens_prefill"] + cache_stats["hit_tokens"] != prompt_tokens:
        raise AssertionError(
            f"prefilled {stats['tokens_prefill']} + cached "
            f"{cache_stats['hit_tokens']} != {prompt_tokens} prompt tokens")
    if audit.failures:
        raise AssertionError(f"the KV ledger did not conserve: "
                             f"{audit.failures[:3]}")
    demoted_streams = sorted(sid for sid, blocks in audit.demotions.items()
                             if blocks)
    if demoted_streams != sorted(texts) or not cache_stats["promoted"]:
        raise AssertionError(f"streams demoted {demoted_streams}, "
                             f"{cache_stats['promoted']} blocks promoted")
    rounds = list(timer.rounds)

    # one round with promotions and extends under the profiler: a fourth
    # turn on every stream, their chains demoted first
    demote_between_turns(agents)(AGENT_TURNS)
    for stream_id in texts:
        pipeline.post("process_frame", stream_id, {"text": "and then?"})
    while engine.step():
        pass
    profile = profile_round(decoder, "agent_tiered promotions + extends")
    drained = engine.clock.now() + 60.0
    while not decoder.idle and engine.clock.now() < drained:
        engine.clock.advance(0.002)
        while engine.step():
            pass
    histories = {stream_id: list(agent._session_table.get(
        "default", stream_id)["history"]) for stream_id in texts}
    settle_virtual(engine, AGENT_PARAMETERS["session_lease"] + 1.0)
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    host_blocks_before = len(store)
    promoted_back = promote_and_purge(cache, histories)
    assert_ledger_clean(cache=cache, ledger=audit.ledger)
    audit.close()
    promoter.stop()
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    record = {
        "phase": "agent_tiered", "streams": AGENT_STREAMS,
        "turns": AGENT_TURNS, "frames": len(frames),
        "cache_blocks_budget": AGENT_TIERED_BLOCKS,
        "prefix_cache_mb": parameters["prefix_cache_mb"],
        "host_kv_mb": AGENT_TIERED_HOST_MB,
        "prompt_tokens": prompt_tokens,
        "tokens_prefill": stats["tokens_prefill"],
        "hit_tokens": cache_stats["hit_tokens"],
        "promoted_tokens": cache_stats["promoted"] * cache.block_tokens,
        "prefix_admits": stats["prefix_admits"],
        "demoted_blocks": cache_stats["demoted"],
        "promoted_blocks": cache_stats["promoted"],
        "cache_evictions": cache_stats["evictions"],
        "host_evicted": store.stats["evicted"],
        "host_refused": store.stats["refused"],
        "promoter": dict(promoter.stats),
        "session_demotions": dict(audit.demotions),
        "decode_steps": stats["steps"],
        "extend_dispatches": extend_dispatches,
        "paged_launches": measured, "paged_launches_expected": expected,
        "stream_syncs": sum(syncs.values()),
        "ledger_rounds_audited": audit.rounds,
        "ledger_violations": len(audit.ledger.violations),
        "ledger_events": dict(audit.ledger.stats),
        "host_blocks_at_end": host_blocks_before,
        "promoted_back": promoted_back,
        "pool_blocks_after_purge": decoder.pool.used_blocks(),
        "host_blocks_after_purge": len(store),
        "virtual_s": virtual_s, "wall_s": wall_s, "rounds": len(rounds),
        "first_round_s": rounds[0],
        "steady_round_s": statistics.median(rounds[2:]),
        "tokens": sum(len(f.swag["response_tokens"])
                      for f in frames.values()),
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(record)
    emit({"phase": "profile", **profile})
    return measured


def phase_agent_tiered_f32() -> dict:
    """agent_tiered's conversation at full width and 2 layers in f32:
    every turn against llama_greedy_decode on its whole history prompt
    (a first mismatch at a top-2 logit gap under 1e-4 is a tie), with
    chains demoted and promoted between the turns."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with agent_preset(num_layers=2, dtype=torch.float32) as config:
        check_1b(config)
        runtime, compute = host_runtime()
        prompts, agents = {}, []

        def before_drive(agent):
            agents.append(agent)
            submit = agent.decoder.submit

            def recording(request_id, prompt, *args, **kwargs):
                prompts[request_id] = list(prompt)
                return submit(request_id, prompt, *args, **kwargs)
            agent.decoder.submit = recording

        pipeline, agent, frames, virtual_s, wall_s = conversation(
            runtime, agent_texts(np.random.default_rng(AGENT_SEED)),
            before_drive, tiered_parameters(config),
            demote_between_turns(agents))
        ties, identical = [], 0
        for frame in frames.values():
            request_id = f"{frame.stream_id}.{frame.frame_id}"
            tie = greedy_check(agent.params, config, prompts[request_id],
                               list(frame.swag["response_tokens"]),
                               request_id)
            if tie is None:
                identical += 1
            else:
                ties.append(tie)
    cache = agent.prefix_cache
    if len(frames) != AGENT_STREAMS * AGENT_TURNS or \
            not cache.stats["demoted"] or not cache.stats["promoted"]:
        raise AssertionError(f"{len(frames)} frames, "
                             f"{cache.stats['demoted']} demoted, "
                             f"{cache.stats['promoted']} promoted")
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    cache.promoter.stop()
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    record = {"phase": "agent_tiered_f32", "frames": len(frames),
              "identical": identical, "ties": ties,
              "demoted_blocks": cache.stats["demoted"],
              "promoted_blocks": cache.stats["promoted"],
              "hit_tokens": cache.stats["hit_tokens"],
              "prefix_admits": agent.decoder.stats["prefix_admits"],
              "virtual_s": virtual_s, "wall_s": wall_s}
    emit(record)
    return record


def serve_llama_traffic(decoder, requests) -> tuple:
    """The llama phase's drive: the first 16 requests, the other 8 after
    the first round, pumped until idle.  Returns (tokens by request,
    wall s, round s)."""
    done, round_s = {}, []

    def keep(request_id, tokens):
        done[request_id] = list(tokens)

    start = time.perf_counter()
    for rid, prompt, new in requests[:16]:
        decoder.submit(rid, prompt, new, keep)
    while True:
        round_start = time.perf_counter()
        decoder.pump()
        round_s.append(time.perf_counter() - round_start)
        if len(round_s) == 1:
            for rid, prompt, new in requests[16:]:
                decoder.submit(rid, prompt, new, keep)
        if decoder.idle:
            break
        if len(round_s) > 500:
            raise AssertionError("the decoder did not drain in 500 rounds")
    torch.cuda.synchronize()
    return done, time.perf_counter() - start, round_s


def check_served(done, requests, vocab: int, label: str) -> int:
    budgets = {rid: new for rid, _, new in requests}
    if sorted(done) != sorted(budgets):
        raise AssertionError(f"{label}: {len(done)} of {len(budgets)} "
                             f"completed")
    for rid, tokens in done.items():
        if len(tokens) != budgets[rid] or \
                not all(0 <= t < vocab for t in tokens):
            raise AssertionError(f"{label} request {rid}: {len(tokens)} "
                                 f"tokens of {budgets[rid]}")
    return sum(len(tokens) for tokens in done.values())


def card_against_cpu(options: dict, seed: int, label: str,
                     decoder_kwargs: dict | None = None) -> dict:
    """The decoder with `options` at full width and 2 layers in f32 on
    the card against the same decoder on the CPU (the kernels' plain
    versions) on the same weights: 4 requests of 24 new tokens; a first
    mismatch passes only at a CPU top-2 logit gap under 1e-4."""
    import copy

    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = dataclasses.replace(LLAMA_PRESETS["1b"], num_layers=2,
                                 dtype=torch.float32, max_seq_len=1024)
    params = llama_init(torch.Generator(device="cuda").manual_seed(seed),
                        config)
    cpu_params = copy.deepcopy(params).cpu()
    rng = np.random.default_rng(seed)
    prompts = {f"q{n}": rng.integers(0, config.vocab, n).tolist()
               for n in (20, 57, 100, 128)}
    max_new = 24
    kwargs = {**(decoder_kwargs or LLAMA_DECODER), "max_slots": 4,
              **options}
    runs = {}
    for device, weights in (("cuda", params), ("cpu", cpu_params)):
        decoder = ContinuousDecoder(weights, config, device=device, **kwargs)
        gaps = LogitGaps(decoder) if device == "cpu" else None
        done = {}
        try:
            with torch.inference_mode():
                for rid, prompt in prompts.items():
                    decoder.submit(rid, prompt, max_new,
                                   lambda r, t: done.update({r: list(t)}))
                requests = list(decoder._pending)
                while not decoder.idle:
                    decoder.pump()
        finally:
            if gaps is not None:
                gaps.close()
        cpu_gaps = {r.request_id: gaps.by_slot[r.slot] for r in requests} \
            if gaps is not None else None
        runs[device] = (done, cpu_gaps, decoder._param_bytes)
    got, _, param_bytes = runs["cuda"]
    ref, cpu_gaps, _ = runs["cpu"]
    ties, identical = [], 0
    for rid in prompts:
        if len(got[rid]) != max_new or len(ref[rid]) != max_new:
            raise AssertionError(f"{label} request {rid}: {len(got[rid])} "
                                 f"/ {len(ref[rid])} tokens of {max_new}")
        mismatch = next((i for i, (a, b) in enumerate(zip(got[rid],
                                                          ref[rid]))
                         if a != b), None)
        if mismatch is None:
            identical += 1
            continue
        gap = cpu_gaps[rid][mismatch][1]
        if gap >= 1e-4:
            raise AssertionError(
                f"{label} request {rid}: card token {got[rid][mismatch]} "
                f"!= CPU {ref[rid][mismatch]} at step {mismatch}, CPU "
                f"top-2 gap {gap}")
        ties.append({"request": rid, "step": mismatch, "gap": gap})
    return {"requests": len(prompts), "identical": identical, "ties": ties,
            "param_bytes_f32_2_layers": param_bytes,
            "min_cpu_gap": min(g for rid in prompts
                               for _, g in cpu_gaps[rid])}


def phase_llama_wq() -> dict:
    """The llama phase's traffic through its paged decoder with
    weight_quant, then with fuse_projections (bf16, full width at
    LLAMA_CUT_LAYERS of Llama-1B's 16 layers since PR 25: the script's
    time): every request completes, the paged kernel launches
    LLAMA_CUT_LAYERS x LLAMA_WQ_STEPS each; tokens/s, the decoder's parameter bytes (JAX's _param_bytes
    rule: every weight but the embedding, the fused copy once), peak
    memory.  Then both at 2 layers in f32 on the card against the CPU.
    Returns the decode launches of both runs."""
    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = dataclasses.replace(LLAMA_PRESETS["1b"], dtype=torch.bfloat16,
                                 max_seq_len=1024,
                                 num_layers=LLAMA_CUT_LAYERS)
    check_1b(config)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    requests = llama_traffic(np.random.default_rng(0), config.vocab)
    plain_bytes = ContinuousDecoder(params, config, **{
        **LLAMA_DECODER, "max_slots": 1})._param_bytes
    records, total = {}, 0
    for name, options in (("weight_quant", {"weight_quant": True}),
                          ("fuse_projections", {"fuse_projections": True})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        decoder = ContinuousDecoder(params, config, **LLAMA_DECODER,
                                    **options)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - start
        # the main path's run: counts set to 0 just before, read after
        for key in P.launches:
            P.launches[key] = 0
        done, wall, round_s = serve_llama_traffic(decoder, requests)
        launches = dict(P.launches)
        generated = check_served(done, requests, config.vocab, name)
        steps = decoder.stats["steps"]
        if steps != LLAMA_WQ_STEPS or launches["paged_decode_attention"] \
                != config.num_layers * steps or decoder.pool.used_blocks():
            raise AssertionError(f"{name}: {steps} decode steps, launches "
                                 f"{launches}, {decoder.pool.used_blocks()}"
                                 f" blocks owned")
        total += launches["paged_decode_attention"]
        records[name] = {
            "tokens": generated, "setup_s": setup_s, "wall_s": wall,
            "tokens_per_s": generated / wall, "rounds": len(round_s),
            "steady_round_s": statistics.median(round_s[2:]),
            "steps": steps, "paged_launches":
                launches["paged_decode_attention"],
            "param_bytes": decoder._param_bytes,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sample_tokens": done["r0"][:6]}
        del decoder
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    f32 = {name: card_against_cpu(options, 6, name) for name, options in (
        ("weight_quant", {"weight_quant": True}),
        ("fuse_projections", {"fuse_projections": True}))}
    record = {"phase": "llama_wq", "requests": len(requests),
              "param_bytes_bf16": plain_bytes, **records, "f32": f32}
    emit(record)
    return {"decode": total}


def phase_llama_select() -> dict:
    """The dense decoder in the select KV write (AIKO_DECODE_KV=select):
    the llama phase's traffic at full width in bf16 (LLAMA_CUT_LAYERS of
    the 16 layers since PR 25) with the two_pass inner loop (tokens/s,
    no paged launch); then, at 2 layers in f32,
    each inner loop (two_pass, online, vpu) and the block write against
    llama_greedy_decode, and each select run against the block run."""
    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    saved = {key: os.environ.get(key) for key in ("AIKO_DECODE_KV",
                                                  "AIKO_DECODE_ATTENTION")}
    try:
        config = dataclasses.replace(LLAMA_PRESETS["1b"],
                                     dtype=torch.bfloat16, max_seq_len=1024,
                                     num_layers=LLAMA_CUT_LAYERS)
        check_1b(config)
        params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                            config)
        os.environ["AIKO_DECODE_KV"] = "select"
        os.environ["AIKO_DECODE_ATTENTION"] = "two_pass"
        decoder = ContinuousDecoder(params, config, **{**LLAMA_DECODER,
                                                       "paged_kv": False})
        requests = llama_traffic(np.random.default_rng(0), config.vocab)
        for key in P.launches:
            P.launches[key] = 0
        done, wall, round_s = serve_llama_traffic(decoder, requests)
        if any(P.launches.values()):
            raise AssertionError(f"select launched {P.launches}")
        generated = check_served(done, requests, config.vocab, "select")
        full = {"tokens": generated, "wall_s": wall,
                "tokens_per_s": generated / wall, "rounds": len(round_s),
                "steady_round_s": statistics.median(round_s[2:]),
                "steps": decoder.stats["steps"],
                "kv_cache_bytes": decoder.kv_cache_bytes()}
        del decoder, params
        torch.cuda.empty_cache()

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        small = dataclasses.replace(LLAMA_PRESETS["1b"], num_layers=2,
                                    dtype=torch.float32, max_seq_len=1024)
        params = llama_init(torch.Generator(device="cuda").manual_seed(7),
                            small)
        rng = np.random.default_rng(7)
        prompts = {f"s{n}": rng.integers(0, small.vocab, n).tolist()
                   for n in (20, 57, 100, 128)}
        runs = {}
        for kv_write, impl in (("block", "two_pass"),) + tuple(
                ("select", impl) for impl in SELECT_IMPLS):
            os.environ["AIKO_DECODE_KV"] = kv_write
            os.environ["AIKO_DECODE_ATTENTION"] = impl
            decoder = ContinuousDecoder(params, small, **{
                **LLAMA_DECODER, "paged_kv": False, "max_slots": 4})
            got = {}
            for rid, prompt in prompts.items():
                decoder.submit(rid, prompt, 24,
                               lambda r, t: got.update({r: list(t)}))
            while not decoder.idle:
                decoder.pump()
            runs[f"{kv_write}_{impl}"] = got
        checks = {}
        for label, got in runs.items():
            ties, identical, same_as_block = [], 0, 0
            for rid, prompt in prompts.items():
                tie = greedy_check(params, small, prompt, got[rid],
                                   f"{label} {rid}")
                identical += tie is None
                if tie is not None:
                    ties.append(tie)
                same_as_block += got[rid] == runs["block_two_pass"][rid]
            checks[label] = {"identical": identical, "ties": ties,
                             "equal_to_block": same_as_block}
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    record = {"phase": "llama_select", "full_width_two_pass": full,
              "f32": checks}
    emit(record)
    return record


def chaos_traffic(rng, vocab: int) -> tuple:
    """(the llama traffic with the tenants alternating, 4 later requests
    of fresh 16-128-token prompts and 48 new tokens): [(id, prompt, new,
    tenant)] each."""
    traffic = [(rid, prompt, new, CHAOS_TENANTS[i % 2])
               for i, (rid, prompt, new) in enumerate(
                   llama_traffic(rng, vocab))]
    later = [(f"late{i}", rng.integers(0, vocab, int(rng.integers(
        16, 129))).tolist(), 48, CHAOS_TENANTS[i % 2]) for i in range(4)]
    return traffic, later


def chaos_drive(config, params, device, traffic: list, later: list,
                faults: bool, preempt_round: int = CHAOS_PREEMPT_ROUND) -> dict:
    """Serve `traffic` [(id, prompt, new, tenant)] through a ChaosDecoder
    around the prefix-cached paged decoder (CHAOS_DECODER), the first 16
    at once and the rest after the first round, then `later`'s 4
    requests, two at a time once the decoder is idle.  With `faults`: a
    preemption at `preempt_round`; under the first pair, the free
    list held dry and a pool-growth refusal armed for
    CHAOS_REFUSAL_ROUNDS rounds; under the second, a hung round (the
    injected clock stamps its end CHAOS_HANG_S late).  Each fault drains
    (deadline 0), the evacuated requests are resubmitted from prompt +
    generated after resume, and a request's tokens are its partial
    generation plus its continuation.  Returns the run's record."""
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    from aiko_services_tpu_torch.serving_chaos import ChaosDecoder

    cache = PrefixKVCache(block_tokens=CHAOS_DECODER["kv_block"],
                          max_bytes=512 << 20, name=f"chaos_{device}")
    decoder = ContinuousDecoder(params, config, device=device,
                                prefix_cache=cache, name=f"chaos_{device}",
                                **CHAOS_DECODER)
    hang = {"armed": False, "calls": 0}

    def clock():
        # armed, the second stamp (a round's end) comes CHAOS_HANG_S late
        if hang["armed"]:
            hang["calls"] += 1
            if hang["calls"] == 2:
                hang["armed"] = False
                return time.perf_counter() + CHAOS_HANG_S
        return time.perf_counter()

    chaos = ChaosDecoder(decoder, name=f"smoke_{device}", clock=clock,
                         drain_deadline=0.0)
    kinds, evacuated = [], []
    chaos.on_alert.append(lambda kind, detail: kinds.append(kind))
    chaos.on_evacuate = evacuated.append
    done, partial, budgets, tenants = {}, {}, {}, {}
    submissions = [0]

    def submit(rid, prompt, new, tenant):
        budgets.setdefault(rid, new)
        tenants[rid] = tenant
        submissions[0] += 1

        def keep(_request_id, tokens, rid=rid):
            done[rid] = partial.get(rid, []) + list(tokens)
        decoder.submit(f"{rid}.{submissions[0]}", prompt, new, keep,
                       tenant=tenant)

    def resubmit():
        """After a drain: resume and resubmit every evacuated request."""
        chaos.disarm()
        decoder.resume()
        for descriptor in evacuated:
            rid = descriptor["request_id"].rsplit(".", 1)[0]
            generated = list(descriptor["generated"])
            partial[rid] = partial.get(rid, []) + generated
            submit(rid, list(descriptor["prompt"]) + generated,
                   descriptor["max_new_tokens"] - len(generated),
                   tenants[rid])
        evacuated.clear()

    def pump_until(predicate, limit=600):
        for _ in range(limit):
            if predicate():
                return
            chaos.pump()
        raise AssertionError("the chaos drive did not settle")

    if faults:
        chaos.arm_preemption(preempt_round)
    for request in traffic[:16]:
        submit(*request)
    chaos.pump()
    for request in traffic[16:]:
        submit(*request)
    pump_until(lambda: decoder.drained or decoder.idle)
    if faults:
        resubmit()
        pump_until(lambda: decoder.idle)
        pool = decoder.pool
        # the free list dry, by hand: the fault this phase injects
        # graft: disable=lint-ledger-seam
        held = pool.alloc_blocks(len(pool._free))
        chaos.arm_alloc_refusal(CHAOS_REFUSAL_ROUNDS)
    for request in later[:2]:
        submit(*request)
    pump_until(lambda: decoder.drained or decoder.idle)
    if faults:
        pool.release_blocks(held)  # graft: disable=lint-ledger-seam
        resubmit()
        pump_until(lambda: decoder.idle)
        chaos.arm_hung_scan(CHAOS_HANG_THRESHOLD_S)
    for request in later[2:]:
        submit(*request)
    chaos.pump()                           # admits
    chaos.pump()                           # decoding
    if faults:
        hang["armed"] = True               # this round "hangs"
    pump_until(lambda: decoder.drained or decoder.idle)
    if faults:
        resubmit()
        pump_until(lambda: decoder.idle)
    torch.cuda.synchronize()
    outcomes = collections.Counter(journey.outcome for journey in
                                   decoder.journeys.journeys())
    sketches = {tenant: decoder.slo_sketch_stats(tenant=tenant)
                for tenant in CHAOS_TENANTS}
    record = {"done": done, "budgets": budgets, "kinds": kinds,
              "chaos": dict(chaos.stats), "submissions": submissions[0],
              "journeys": len(decoder.journeys.journeys()),
              "outcomes": dict(outcomes),
              "ttft_p50_ms": {tenant: sketch["ttft_p50_ms"]
                              for tenant, sketch in sketches.items()},
              "stats": {key: decoder.stats[key] for key in (
                  "drain_evacuated", "drain_checkpoints", "drain_refused",
                  "steps", "prefix_admits", "completed", "prefill_chunks")},
              "pool_blocks_used": decoder.pool.used_blocks()}
    cache.purge(demote=False)
    record["pool_blocks_after_purge"] = decoder.pool.used_blocks()
    return record


def phase_decoder_chaos() -> dict:
    """ChaosDecoder around the prefix-cached paged Llama-1B decoder
    (bf16, LLAMA_CUT_LAYERS of its 16 layers since PR 25): preemption, pool-growth refusal and a hung scan, each drained
    with a checkpoint and resumed (chaos_drive).  Every request completes
    with its budget, the evacuated and checkpointed counts are the
    rehearsal's, the flight recorder holds one record per injected fault,
    one journey per submission, a TTFT p50 per tenant; then at 2 layers
    in f32 the faulted run's tokens against the same drive without
    faults.  Returns the paged launches by path."""
    import logging

    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
    from aiko_services_tpu_torch.observe import flight
    from aiko_services_tpu_torch.ops import paged_attention as P

    config = dataclasses.replace(LLAMA_PRESETS["1b"], dtype=torch.bfloat16,
                                 max_seq_len=1024,
                                 num_layers=LLAMA_CUT_LAYERS)
    check_1b(config)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    traffic, later = chaos_traffic(np.random.default_rng(0),
                                   config.vocab)
    recorder = flight.FlightRecorder(name="decoder_chaos")
    handler = flight.FlightLogHandler()
    logging.getLogger("serving.chaos").addHandler(handler)
    extends = [0, 0]
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    extend_group = ContinuousDecoder._extend_group

    def counted(decoder, *args, **kwargs):
        before = sum(P.launches.values())
        extends[0] += 1
        extend_group(decoder, *args, **kwargs)
        extends[1] += sum(P.launches.values()) - before

    ContinuousDecoder._extend_group = counted
    try:
        for key in P.launches:
            P.launches[key] = 0
        start = time.perf_counter()
        run = chaos_drive(config, params, "cuda", traffic, later,
                          faults=True)
        wall = time.perf_counter() - start
        launches = dict(P.launches)
    finally:
        ContinuousDecoder._extend_group = extend_group
        logging.getLogger("serving.chaos").removeHandler(handler)
        recorder.close()
    faults = [log for log in recorder.logs if "fault at round" in log[3]]
    for rid, budget in run["budgets"].items():
        tokens = run["done"].get(rid)
        if tokens is None or len(tokens) != budget:
            raise AssertionError(f"chaos request {rid}: "
                                 f"{None if tokens is None else len(tokens)}"
                                 f" tokens of {budget}")
    stats = run["stats"]
    measured = {"decode": launches["paged_decode_attention"] - extends[1],
                "extend": extends[1]}
    expected = {"decode": config.num_layers * CHAOS_DECODE_STEPS,
                "extend": config.num_layers * CHAOS_EXTEND_DISPATCHES}
    predicted = {"evacuated": CHAOS_EVACUATED,
                 "checkpoints": CHAOS_CHECKPOINTS}
    got = {"evacuated": stats["drain_evacuated"],
           "checkpoints": stats["drain_checkpoints"]}
    if run["kinds"] != ["preemption", "pool_refusal", "hung_scan"] or \
            len(faults) != 3 or got != predicted or measured != expected \
            or stats["steps"] != CHAOS_DECODE_STEPS or \
            extends[0] != CHAOS_EXTEND_DISPATCHES or \
            run["journeys"] != run["submissions"] or \
            None in run["ttft_p50_ms"].values() or \
            run["pool_blocks_after_purge"]:
        raise AssertionError(
            f"decoder_chaos: faults {run['kinds']} ({len(faults)} flight "
            f"records), {got} (predicted {predicted}), launches {measured} "
            f"(predicted {expected}), {stats['steps']} steps, "
            f"{extends[0]} extends, {run['journeys']} journeys of "
            f"{run['submissions']} submissions, ttft {run['ttft_p50_ms']}, "
            f"{run['pool_blocks_after_purge']} blocks after purge")
    del params
    torch.cuda.empty_cache()

    # f32 at 2 layers: the faulted drive against the same drive unfaulted
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dataclasses.replace(LLAMA_PRESETS["1b"], num_layers=2,
                                dtype=torch.float32, max_seq_len=1024)
    params = llama_init(torch.Generator(device="cuda").manual_seed(8),
                        small)
    rng = np.random.default_rng(8)
    requests_f32 = [(f"f{i}", rng.integers(0, small.vocab, n).tolist(), 48,
                     CHAOS_TENANTS[i % 2])
                    for i, n in enumerate((20, 57, 100, 128, 33, 90, 64,
                                           120, 41, 77))]
    traffic_f32, later_f32 = requests_f32[:6], requests_f32[6:]
    # preempted at round 3: the first 16 decode steps ran, every stream
    # checkpoints mid-generation
    faulted = chaos_drive(small, params, "cuda", traffic_f32, later_f32,
                          faults=True, preempt_round=3)
    clean = chaos_drive(small, params, "cuda", traffic_f32, later_f32,
                        faults=False)
    ties, identical = [], 0
    for rid, prompt, new, _ in requests_f32:
        got_tokens, want = faulted["done"][rid], clean["done"][rid]
        if got_tokens == want:
            identical += 1
            continue
        tie = greedy_check(params, small, prompt, got_tokens, f"resumed {rid}")
        if tie is None:
            tie = greedy_check(params, small, prompt, want, f"clean {rid}")
        if tie is None:
            raise AssertionError(f"chaos f32 {rid}: resumed {got_tokens} "
                                 f"!= unpreempted {want}")
        ties.append(tie)
    record = {"phase": "decoder_chaos", "requests": len(run["budgets"]),
              "submissions": run["submissions"], "faults": run["kinds"],
              "flight_fault_records": len(faults), "chaos": run["chaos"],
              "evacuated": got["evacuated"],
              "checkpoints": got["checkpoints"],
              "journeys": run["journeys"], "outcomes": run["outcomes"],
              "ttft_p50_ms": run["ttft_p50_ms"],
              "decode_steps": stats["steps"], "extend_dispatches": extends[0],
              "paged_launches": measured, "paged_launches_expected": expected,
              "prefix_admits": stats["prefix_admits"], "wall_s": wall,
              "f32": {"requests": len(requests_f32), "identical": identical,
                      "ties": ties,
                      "checkpoints": faulted["stats"]["drain_checkpoints"],
                      "evacuated": faulted["stats"]["drain_evacuated"]}}
    emit(record)
    return measured


def disagg_config(**changes):
    """The 1b preset as the JAX bench's disaggregated rung serves it:
    bf16, max_seq_len 1024 (`changes` on top)."""
    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS
    return dataclasses.replace(LLAMA_PRESETS["1b"], **{
        "dtype": torch.bfloat16, "max_seq_len": 1024, **changes})


def disagg_probe_prompt(vocab: int) -> list:
    import numpy as np
    return np.random.default_rng(DISAGG_PROBE["seed"]).integers(
        1, vocab, size=DISAGG_PROBE["tokens"]).tolist()


def probe_tokens(harness, prompt) -> list:
    """The probe through `harness` (its client when disaggregated)."""
    done = {}
    harness.submit("probe", prompt, DISAGG_PROBE["new"],
                   lambda rid, t: done.update({rid: [int(x) for x in t]}))
    if not harness.run_until(lambda: "probe" in done, timeout=300.0):
        raise AssertionError("the disagg probe never completed")
    return done["probe"]


def pool_rows(pool, ids) -> list:
    """Device copies of pool blocks `ids`: [per block [per layer {"k",
    "v"}]], each leaf a tensor or the int8 dict (one index_select per
    layer and plane, queued on the stream: no host sync)."""
    index = pool._ids(ids)

    def take(leaf):
        if isinstance(leaf, dict):
            return {key: plane.index_select(0, index)
                    for key, plane in leaf.items()}
        return leaf.index_select(0, index)

    layers = [(take(k), take(v)) for k, v in zip(pool.k_pools,
                                                 pool.v_pools)]

    def row(leaf, j):
        return {key: plane[j] for key, plane in leaf.items()} \
            if isinstance(leaf, dict) else leaf[j]
    return [[{"k": row(k, j), "v": row(v, j)} for k, v in layers]
            for j in range(len(ids))]


class ShipRecord:
    """Bytes that crossed against bytes that landed.  Wraps, at their
    module and classes, serving_disagg._chain_wire_blocks (the host rows
    each chain key shipped, kept by key), PrefixKVCache.install_chain
    (device copies of the pool blocks an install added, by key: a key
    the cache held already is not an installed block) and
    ContinuousDecoder.install_shipped_blocks (the same for a cacheless
    pool's direct install).  verify() compares every installed block
    with the shipped one by torch.equal, plane by plane; close()
    restores the wrapped functions."""

    def __init__(self):
        from aiko_services_tpu_torch import serving_disagg as D
        from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                     PrefixKVCache,
                                                     prefix_chain_keys)
        self.shipped, self.installed = {}, []
        self._saved = ((D, "_chain_wire_blocks", D._chain_wire_blocks),
                       (PrefixKVCache, "install_chain",
                        PrefixKVCache.install_chain),
                       (ContinuousDecoder, "install_shipped_blocks",
                        ContinuousDecoder.install_shipped_blocks))
        record = self
        (_, _, ship), (_, _, install), (_, _, direct) = self._saved

        def shipping(cache, keys):
            rows = ship(cache, keys)
            for key, block in zip(keys, rows.blocks):
                record.shipped.setdefault(key, block)
            return rows

        def installing(cache, tenant, tokens, start_block, blocks):
            keys = cache.keys_for(tenant, [int(t) for t in tokens])
            fresh = [key for key in keys[start_block:start_block +
                                         len(blocks)]
                     if not cache.has(key)]
            installed = install(cache, tenant, tokens, start_block, blocks)
            nodes = [cache._nodes[key] for key in fresh
                     if key in cache._nodes]
            if nodes and cache.paged:
                record.installed.extend(zip(
                    [node.key for node in nodes],
                    pool_rows(cache.pool, [n.pool_id for n in nodes])))
            return installed

        def direct_install(decoder, tokens, start_block, blocks,
                           tenant=""):
            covered, ids = direct(decoder, tokens, start_block, blocks,
                                  tenant=tenant)
            keys = prefix_chain_keys(tenant, [int(t) for t in tokens],
                                     decoder.kv_block)
            record.installed.extend(zip(
                keys[start_block:start_block + len(ids)],
                pool_rows(decoder.pool, ids)))
            return covered, ids

        D._chain_wire_blocks = shipping
        PrefixKVCache.install_chain = installing
        ContinuousDecoder.install_shipped_blocks = direct_install

    def verify(self) -> dict:
        torch.cuda.synchronize()
        equal = unmatched = 0
        for key, landed in self.installed:
            sent = self.shipped.get(key)
            if sent is None:
                unmatched += 1
                continue
            for got, want in zip(landed, sent):
                for side in ("k", "v"):
                    a, b = got[side], want[side]
                    pairs = [(a[p], b[p]) for p in ("q", "s")] \
                        if isinstance(a, dict) else [(a, b)]
                    for x, y in pairs:
                        if not torch.equal(x.cpu(), y.cpu()):
                            raise AssertionError(
                                f"installed block {key[:12]} differs "
                                f"from the shipped one ({side})")
            equal += 1
        if unmatched or not equal:
            raise AssertionError(f"{equal} installed blocks compared, "
                                 f"{unmatched} never shipped")
        return {"blocks_compared": equal,
                "blocks_shipped": len(self.shipped)}

    def close(self) -> None:
        for owner, name, value in self._saved:
            setattr(owner, name, value)


class SideLaunches:
    """Paged kernel launches by decoder (the decoder object), counted
    around every ContinuousDecoder.pump (wrapped at the class: the
    harness registers the bound methods at construction); close()
    restores it."""

    def __init__(self):
        from aiko_services_tpu_torch.ops import paged_attention as P
        from aiko_services_tpu_torch.serving import ContinuousDecoder
        self.by_decoder = collections.Counter()
        self._class, self._pump = ContinuousDecoder, ContinuousDecoder.pump
        pump, counter = self._pump, self.by_decoder

        def counted(decoder):
            before = sum(P.launches.values())
            pump(decoder)
            counter[decoder] += sum(P.launches.values()) - before

        ContinuousDecoder.pump = counted

    def close(self) -> None:
        self._class.pump = self._pump


def split_launches(launches: dict, extends: list) -> dict:
    """A run's paged launches by (variant, path): the extend launches
    counted around _extend_group go to the dequantizing variant on an
    int8 pool and to the native one otherwise; the rest decode."""
    out = collections.Counter()
    extend = extends[1]
    for variant, count in launches.items():
        if variant == "paged_decode_attention_int8_dequant":
            out[(variant, "extend")] += count
            extend -= count
        elif variant == "paged_decode_attention_int8_fold":
            out[(variant, "decode")] += count
    native = launches.get("paged_decode_attention", 0)
    out[("paged_decode_attention", "extend")] += max(0, extend)
    out[("paged_decode_attention", "decode")] += native - max(0, extend)
    return {key: value for key, value in out.items() if value}


def disagg_harness(params, config, disagg: bool, **changes):
    from aiko_services_tpu_torch.serving_disagg import DisaggHarness
    kwargs = {**DISAGG_HARNESS, **changes}
    kwargs["decoder_opts"] = {**DISAGG_HARNESS["decoder_opts"],
                              **changes.get("decoder_opts", {})}
    harness = DisaggHarness(params, config, disagg=disagg, **kwargs)
    if disagg and not harness.wait_discovered(30.0):
        harness.stop()
        raise AssertionError("the prefill pool was never discovered")
    return harness


def phase_disagg() -> dict:
    """DisaggHarness on Llama-1B in bf16 with the JAX rung's geometry
    (DISAGG_HARNESS), colocated and then disaggregated: the probe (a
    200-token prompt, 16 new tokens), then measure(): 6 decode streams
    and, in the window's second half, bursts of 4 prompts of 288 tokens
    sharing a 144-token prefix every 0.4 s.  Both runs under torch's sync
    debug mode and a KV memory ledger audited after every decode round.
    Checks: nothing lost, no local fallback, transfers that moved KV and
    handle blocks once the prefix is resident, every installed block
    byte-equal to the shipped one, no synchronizing call, the probe's
    counts (DISAGG_PROBE_COUNTS) and paged launches on both sides.
    Returns the paged launches by (variant, path) of both runs and the
    decode side's suffix extends."""
    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P

    config = disagg_config()
    check_1b(config)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    prompt = disagg_probe_prompt(config.vocab)
    runs, counts, probes = {}, collections.Counter(), {}
    for mode in ("colocated", "disaggregated"):
        disagg = mode == "disaggregated"
        audit, sides = TierAudit(), SideLaunches()
        ships = ShipRecord() if disagg else None
        try:
            harness = disagg_harness(params, config, disagg)
            audit.bind(harness.decoder)
            decode_ext = count_extend_launches(harness.decoder)
            prefill_ext = count_extend_launches(harness.prefill.decoder) \
                if disagg else [0, 0]
            for name in P.launches:
                P.launches[name] = 0
            start = time.perf_counter()
            with sync_watch() as syncs:
                probes[mode] = probe_tokens(harness, prompt)
                probe_stats = {"tokens_prefill":
                               harness.decoder.stats["tokens_prefill"],
                               "prefix_admits":
                               harness.decoder.stats["prefix_admits"]}
                if disagg:
                    probe_stats.update({
                        key: harness.client.stats[key] for key in (
                            "transfers", "installs", "installed_blocks",
                            "chunk_installs", "local_fallbacks")})
                probe_stats["paged_launches"] = sum(P.launches.values())
                measured = harness.measure(window=DISAGG_WINDOW,
                                           burst_every=DISAGG_BURST_EVERY)
            wall = time.perf_counter() - start
            torch.cuda.synchronize()
            launches = dict(P.launches)
            by_side = {"decode": sides.by_decoder[harness.decoder]}
            if disagg:
                by_side["prefill"] = sides.by_decoder[
                    harness.prefill.decoder]
            client = dict(harness.client.stats) if disagg else {}
            prefill = dict(harness.prefill.stats) if disagg else {}
            decoder_stats = dict(harness.decoder.stats)
            landed = ships.verify() if disagg else {}
        finally:
            if ships is not None:
                ships.close()
            sides.close()
            audit.close()
        harness.stop()
        expected = DISAGG_PROBE_COUNTS[mode]
        if probe_stats != expected:
            raise AssertionError(f"disagg {mode} probe: {probe_stats} != "
                                 f"{expected}")
        if measured["lost"] or not measured["drained"] or syncs or \
                audit.failures or measured.get("local_fallbacks", 0):
            raise AssertionError(
                f"disagg {mode}: {measured}, syncs {dict(syncs)}, ledger "
                f"{audit.failures[:3]}")
        decode_side = by_side["decode"]
        prefill_side = by_side.get("prefill", 0)
        if not decode_side or (disagg and not prefill_side):
            raise AssertionError(f"disagg {mode}: paged launches by side "
                                 f"{by_side}")
        if disagg and (client["raw_blocks"] == 0 or
                       client["handle_blocks"] == 0 or
                       client["transfers"] == 0):
            raise AssertionError(f"disagg: transfers {client}")
        # the decode side's extends are the suffixes after a shipped
        # cover; the prefill side's are 64-token chunks
        suffix = decode_ext[1] if disagg else 0
        for key, value in split_launches(
                launches, [0, decode_ext[1] + prefill_ext[1] - suffix]
                ).items():
            counts[key] += value
        counts[("paged_decode_attention", "suffix_extend")] += suffix
        counts[("paged_decode_attention", "decode")] -= suffix
        runs[mode] = {
            "probe": probe_stats, "measure": measured, "wall_s": wall,
            "stream_syncs": sum(syncs.values()),
            "ledger_rounds": audit.rounds,
            "paged_launches_by_side": by_side,
            "extends": {"decode": decode_ext, "prefill": prefill_ext},
            "decode_steps": decoder_stats["steps"],
            "prefix_admits": decoder_stats["prefix_admits"],
            "tokens_prefill": decoder_stats["tokens_prefill"],
            "client": client, "prefill": prefill, "installed": landed}
    probe_launches = sum(run["probe"]["paged_launches"]
                         for run in runs.values())
    record = {"phase": "disagg", "probe_tokens_equal":
              probes["colocated"] == probes["disaggregated"], **runs,
              "paged_launches": {f"{v}/{p}": n
                                 for (v, p), n in counts.items()}}
    emit(record)
    del params
    torch.cuda.empty_cache()
    return dict(counts), probe_launches


def variant_probe(params, config, label: str, cacheless: bool = False,
                  **changes) -> tuple:
    """The probe through a disaggregated harness (`changes` on
    DISAGG_HARNESS), or through a cacheless paged decode pool's own
    PrefillClient beside it: (record, launches by (variant, path))."""
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    from aiko_services_tpu_torch.serving_disagg import PrefillClient

    ships = ShipRecord()
    try:
        harness = disagg_harness(params, config, True, **changes)
        target, client = harness, harness.client
        if cacheless:
            decoder = ContinuousDecoder(
                params, config, max_slots=DISAGG_HARNESS["max_slots"],
                prefill_buckets=DISAGG_HARNESS["prefill_buckets"],
                steps_per_sync=DISAGG_HARNESS["steps_per_sync"],
                prefill_chunk=DISAGG_HARNESS["prefill_chunk"],
                name="cacheless", **DISAGG_HARNESS["decoder_opts"])
            harness.engine.add_flatout_handler(decoder.pump)
            client = PrefillClient(harness.decode_rt, decoder,
                                   name="cacheless",
                                   transfer_timeout=60.0)
            client.add_candidate(harness.prefill.topic_path)

            class Through:
                def submit(self, *args, **kwargs):
                    return client.submit(*args, **kwargs)

                def run_until(self, predicate, timeout=30.0):
                    return harness.run_until(predicate, timeout=timeout)
            target = Through()
        else:
            decoder = harness.decoder
        decode_ext = count_extend_launches(decoder)
        prefill_ext = count_extend_launches(harness.prefill.decoder)
        for name in P.launches:
            P.launches[name] = 0
        tokens = probe_tokens(target, disagg_probe_prompt(config.vocab))
        if cacheless:
            harness.run_until(lambda: decoder.idle, timeout=60.0)
        torch.cuda.synchronize()
        launches = dict(P.launches)
        landed = ships.verify()
        stats = {key: client.stats[key] for key in (
            "transfers", "installs", "installed_blocks", "direct_installs",
            "chunk_installs", "chunk_blocks", "local_fallbacks")}
        record = {"tokens_prefill": decoder.stats["tokens_prefill"],
                  "prefix_admits": decoder.stats["prefix_admits"],
                  "decode_steps": decoder.stats["steps"],
                  "extends": {"decode": decode_ext,
                              "prefill": prefill_ext},
                  "pool_blocks_after": decoder.pool.used_blocks()
                  if cacheless else None, **stats, **landed,
                  "tokens": len(tokens)}
        if cacheless:
            client.stop()
            harness.engine.remove_flatout_handler(decoder.pump)
    finally:
        ships.close()
    harness.stop()
    # the decode side's native extends are suffixes after a shipped
    # cover; int8 extends stay on the dequantizing variant's extend row
    suffix = 0 if "int8" in label else decode_ext[1]
    counts = collections.Counter(split_launches(
        launches, [0, decode_ext[1] + prefill_ext[1] - suffix]))
    counts[("paged_decode_attention", "suffix_extend")] += suffix
    counts[("paged_decode_attention", "decode")] -= suffix
    record["paged_launches"] = sum(launches.values())
    return record, {key: value for key, value in counts.items() if value}


def phase_disagg_variants() -> dict:
    """The probe, disaggregated, three more ways on Llama-1B bf16: int8
    KV (the {"q", "s"} layout ships as the donor stored it), chunk
    streaming off, and a cacheless paged decode pool (the direct
    install_shipped_blocks landing).  Each: the installed blocks byte-
    equal to the shipped ones and the counts of DISAGG_VARIANT_COUNTS.
    Returns the paged launches by (variant, path)."""
    from aiko_services_tpu_torch.models.llama import llama_init

    config = disagg_config()
    check_1b(config)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    runs, counts = {}, collections.Counter()
    for label, options in (
            ("int8", {"decoder_opts": {"kv_cache_dtype": "int8"}}),
            ("chunk_stream_off", {"chunk_stream": False}),
            ("cacheless", {"cacheless": True})):
        record, launches = variant_probe(params, config, label, **options)
        want = DISAGG_VARIANT_COUNTS[label]
        got = {key: record[key] for key in want}
        if got != want:
            raise AssertionError(f"disagg_variants {label}: {got} != "
                                 f"{want}")
        runs[label] = record
        counts.update(launches)
    record = {"phase": "disagg_variants", **runs,
              "paged_launches": {f"{v}/{p}": n
                                 for (v, p), n in counts.items()}}
    emit(record)
    del params
    torch.cuda.empty_cache()
    return dict(counts)


def phase_disagg_f32() -> dict:
    """The probe at full width, 2 layers, f32: colocated, disaggregated,
    and both with int8 KV.  The native runs' tokens against each other
    and llama_greedy_decode, the disaggregated int8 run's against the
    colocated int8 run's, a first split passing only at a top-2 logit
    gap under 1e-4."""
    from aiko_services_tpu_torch.models.llama import llama_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = disagg_config(num_layers=2, dtype=torch.float32)
    params = llama_init(torch.Generator(device="cuda").manual_seed(3),
                        config)
    prompt = disagg_probe_prompt(config.vocab)
    tokens = {}
    for label, disagg, options in (
            ("colocated", False, {}), ("disaggregated", True, {}),
            ("int8_colocated", False,
             {"decoder_opts": {"kv_cache_dtype": "int8"}}),
            ("int8_disaggregated", True,
             {"decoder_opts": {"kv_cache_dtype": "int8"}})):
        harness = disagg_harness(params, config, disagg, **options)
        try:
            tokens[label] = probe_tokens(harness, prompt)
            if disagg and (harness.client.stats["installs"] != 1 or
                           harness.client.stats["local_fallbacks"]):
                raise AssertionError(f"disagg_f32 {label}: "
                                     f"{dict(harness.client.stats)}")
        finally:
            harness.stop()
    checks = {}
    for label in ("colocated", "disaggregated"):
        checks[label] = greedy_check(params, config, prompt, tokens[label],
                                     f"disagg_f32 {label}")
    # int8 KV differs from the dense reference by design: the
    # disaggregated int8 run against the colocated one, a first split
    # passing only at a reference top-2 gap under INT8_TIE_GAP (the
    # llama_int8_f32 rule)
    got, want = tokens["int8_disaggregated"], tokens["int8_colocated"]
    if got != want:
        from aiko_services_tpu_torch.models.llama import llama_forward
        i = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
        with torch.inference_mode():
            logits = llama_forward(params, config, torch.tensor(
                [prompt + want[:i]], device=params.embed.table.device))[
                0, -1]
        top2 = torch.topk(logits, 2).values
        gap = (top2[0] - top2[1]).item()
        if gap >= INT8_TIE_GAP:
            raise AssertionError(f"disagg_f32 int8: {got} != {want} at "
                                 f"step {i}, top-2 gap {gap}")
        checks["int8"] = {"step": i, "gap": gap}
    record = {"phase": "disagg_f32", "tokens": tokens,
              "ties": {k: v for k, v in checks.items() if v is not None},
              "disagg_equals_colocated":
                  tokens["disaggregated"] == tokens["colocated"],
              "int8_equal": got == want}
    emit(record)
    return record


def disagg_runtimes(mesh=None):
    """(host runtime with a ComputeRuntime on the card, over `mesh` when
    given, prefill runtime): two port ProcessRuntimes and a registrar's
    on one virtual-clock engine and in-memory broker, the registrar
    promoted to primary."""
    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.registrar import Registrar
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    engine, broker = EventEngine(VirtualClock()), MemoryBroker()

    def runtime(name):
        def transport(on_message, lwt_topic, lwt_payload, lwt_retain):
            return MemoryMessage(on_message=on_message, broker=broker,
                                 lwt_topic=lwt_topic,
                                 lwt_payload=lwt_payload,
                                 lwt_retain=lwt_retain)
        return ProcessRuntime(name=name, engine=engine,
                              transport_factory=transport).initialize()

    Registrar(runtime("smoke_registrar"))
    engine.clock.advance(2.1)                  # the primary's promotion
    for _ in range(300):
        engine.step()
    host = runtime("chip_smoke")
    ComputeRuntime(host, "compute", mesh=mesh)
    return host, runtime("smoke_prefill")


def phase_agent_disagg() -> tuple:
    """The agent phase's conversation (8 streams x 3 turns, Llama-1B
    bf16, paged, sessions) with role "decode" and disagg true: the
    element's PrefillClient finds a PrefillRuntime (Llama-1B on the same
    parameter tensors, 32-token blocks, 128-token chunks) through the
    registrar.  Checks: every first turn went remote (transfers, installs
    and the remote TTFT population, no local fallback), later turns hit
    the decode side's cache, prefill + cached = prompt tokens, 32 tokens
    a frame, role=decode in the pipeline's tags, and the decode steps,
    extend dispatches and paged launches of AGENT_DISAGG_COUNTS.
    Returns (the paged launches by (variant, path), the run's tokens by
    stream and turn)."""
    run = agent_disagg_run()
    emit({"phase": "agent_disagg", **run["record"]})
    return run["counts"], run["tokens"]


def agent_disagg_run(mesh=None, watch_syncs: bool = False) -> dict:
    """phase_agent_disagg's drive and checks, the agent's ComputeRuntime
    over `mesh` when given; with `watch_syncs` under torch's sync debug
    mode from the drive's start (the count of synchronizing calls in the
    record).  Every block the client installed is read back after the
    drive, where the cache still holds it, and held byte for byte
    against the rows shipped for it.  Returns {"record", "counts",
    "tokens"}."""
    import numpy as np

    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving_disagg import (PrefillRuntime,
                                                        _chain_wire_blocks)
    from aiko_services_tpu_torch.share import ServicesCache

    with agent_preset(dtype=torch.bfloat16) as config:
        check_1b(config)
        runtime, prefill_rt = disagg_runtimes(mesh)
        engine = runtime.event
        texts = agent_texts(np.random.default_rng(AGENT_SEED))
        extends, submitted, prefill, shipped = [], [], [], []
        sides = SideLaunches()

        def before_drive(agent):
            # over a mesh the prefill side's decoder serves on it too
            # (its round note at one rank)
            prefill.append(PrefillRuntime(
                prefill_rt, "agent_prefill", params=agent.params,
                config=agent.decoder.config,
                block_tokens=AGENT_PARAMETERS["prefix_block"],
                max_slots=AGENT_PARAMETERS["max_batch"],
                prefill_buckets=(AGENT_PARAMETERS["prompt_length"],),
                prefill_chunk=AGENT_PARAMETERS["prompt_length"],
                decoder_opts={"paged_kv": True,
                              "kv_block": AGENT_PARAMETERS["prefix_block"],
                              **({} if mesh is None else {"mesh": mesh})}))
            if mesh is not None and prefill[0].decoder.mesh is not mesh:
                raise AssertionError("the prefill side is not on the mesh")
            for _ in range(2000):
                if agent._prefill_client.loads:
                    break
                engine.clock.advance(0.002)
                while engine.step():
                    pass
            if not agent._prefill_client.loads:
                raise AssertionError("the agent's client found no pool")
            extends.extend([count_extend_launches(agent.decoder),
                            count_extend_launches(prefill[0].decoder)])
            client = agent._prefill_client
            for kind in ("land", "chunk"):
                apply = getattr(client, f"_apply_{kind}")

                def recording(entry, tokens, start, blocks, *args,
                              _apply=apply, **kwargs):
                    shipped.append((str(entry["tenant"] or ""),
                                    list(tokens), start, blocks))
                    return _apply(entry, tokens, start, blocks, *args,
                                  **kwargs)
                setattr(client, f"_apply_{kind}", recording)
            submit = agent.decoder.submit

            def recording_submit(request_id, prompt, *args, **kwargs):
                submitted.append(len(prompt))
                return submit(request_id, prompt, *args, **kwargs)
            agent.decoder.submit = recording_submit
            for name in P.launches:
                P.launches[name] = 0
            if watch_syncs:
                torch.cuda.set_sync_debug_mode("warn")

        try:
            with sync_watch(arm=False) as syncs:
                pipeline, agent, frames, virtual_s, wall_s = conversation(
                    runtime, texts, before_drive, parameters=AGENT_DISAGG,
                    services_cache=ServicesCache(runtime))
                if not watch_syncs:
                    syncs.clear()
            torch.cuda.synchronize()
        finally:
            sides.close()
        launches = dict(P.launches)
    decoder, cache = agent.decoder, agent.prefix_cache
    client = dict(agent._prefill_client.stats)
    stats = dict(decoder.stats)
    remote = decoder.slo_sketch_stats(prefill="remote")
    failed = pipeline.recovery_stats["frames_failed"]
    if len(frames) != AGENT_STREAMS * AGENT_TURNS or failed:
        raise AssertionError(f"{len(frames)} agent frames, {failed} failed")
    for (stream_id, turn), frame in frames.items():
        if len(frame.swag["response_tokens"]) != \
                AGENT_PARAMETERS["max_tokens"]:
            raise AssertionError(f"agent_disagg {stream_id} turn {turn}")
    prompt_tokens = sum(submitted)
    hit = cache.stats["hit_tokens"]
    got = {"decode_steps": stats["steps"],
           "extend_dispatches": extends[0][0],
           "prefill_extends": extends[1][0],
           "transfers": client["transfers"],
           "installs": client["installs"],
           "local_fallbacks": client["local_fallbacks"],
           "prefix_admits": stats["prefix_admits"],
           "paged_launches": sum(launches.values())}
    # every turn went remote (no local rung), and the later turns'
    # histories crossed as handles to blocks the decode side held
    local = sum(client[key] for key in ("local_short", "local_cached",
                                        "local_no_pool"))
    if got != AGENT_DISAGG_COUNTS or remote["ttft_p50_ms"] is None or \
            stats["tokens_prefill"] + hit != prompt_tokens or \
            "role=decode" not in pipeline.tags or local or \
            not client["handle_blocks"] or \
            client["transfers"] < AGENT_STREAMS:
        raise AssertionError(
            f"agent_disagg: {got} (predicted {AGENT_DISAGG_COUNTS}), "
            f"remote TTFT {remote['ttft_p50_ms']}, prefilled "
            f"{stats['tokens_prefill']} + cached {hit} of {prompt_tokens}, "
            f"tags {pipeline.tags}, client {client}")
    if syncs:
        raise AssertionError(f"the disaggregated agent synchronized the "
                             f"stream: {dict(syncs)}")
    # the installed blocks the cache still holds, read back, against the
    # rows shipped for them
    compared = 0
    block = AGENT_PARAMETERS["prefix_block"]
    for tenant, tokens, start, blocks in shipped:
        count = min(len(tokens) // block, start + len(blocks))
        keys = cache.keys_for(tenant, tokens[:count * block])[start:]
        held = [(key, rows) for key, rows in zip(keys, blocks)
                if cache.has(key)]
        if not held:
            continue
        host = _chain_wire_blocks(cache, [key for key, _ in held])
        host.wait()
        for (key, rows), layers in zip(held, host.blocks):
            for side in ("k", "v"):
                for sent, kept in zip(rows[side],
                                      [layer[side] for layer in layers]):
                    if not torch.equal(leaf_bytes(sent), leaf_bytes(kept)):
                        raise AssertionError(
                            f"installed block {key} differs from the "
                            f"shipped rows")
            compared += 1
    if not compared:
        raise AssertionError("no installed block left to compare")
    tokens = {f"{stream}/{turn}": [int(t) for t in
                                   frame.swag["response_tokens"]]
              for (stream, turn), frame in frames.items()}
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    pipeline.stop()
    by_side = {"decode": sides.by_decoder[decoder],
               "prefill": sides.by_decoder[prefill[0].decoder]}
    prefill[0].stop()
    runtime.terminate()
    prefill_rt.terminate()
    # prefill_chunk is the prompt length (128): every extend on either
    # side runs at the agent's 512-row shape
    counts = collections.Counter()
    counts[("paged_decode_attention", "extend_512")] += \
        extends[0][1] + extends[1][1]
    counts[("paged_decode_attention", "decode")] += \
        sum(launches.values()) - extends[0][1] - extends[1][1]
    record = {**got, "prompt_tokens": prompt_tokens,
              "tokens_prefill": stats["tokens_prefill"], "hit_tokens": hit,
              "client": client, "remote_ttft_p50_ms": remote["ttft_p50_ms"],
              "paged_launches_by_side": by_side, "virtual_s": virtual_s,
              "wall_s": wall_s, "installed_blocks_compared": compared,
              "stream_syncs": sum(syncs.values())}
    return {"record": record, "tokens": tokens,
            "counts": {key: value for key, value in counts.items()
                       if value}}


def leaf_bytes(leaf) -> torch.Tensor:
    """A KV leaf's (or an int8 dict's planes') raw bytes on the host."""
    import numpy as np
    if isinstance(leaf, dict):
        return torch.cat([leaf_bytes(leaf[key]) for key in sorted(leaf)])
    tensor = torch.as_tensor(np.asarray(leaf)) \
        if not isinstance(leaf, torch.Tensor) else leaf
    return tensor.detach().cpu().contiguous().view(-1).view(torch.uint8)


class MigrateSide:
    """One serving side of the migration phase: a paged decoder on
    `params` (over `mesh` when given: its migrator then lands sessions
    at the decoder's round note), a prefix cache (with a host tier of
    host_mb MiB when given), a session table, a SessionMigrator and a KV
    memory ledger, pumping flat-out on the shared real-clock engine and
    broker (JAX's tests/test_drain_migrate.py _Side)."""

    def __init__(self, engine, broker, params, config, name, host_mb=0,
                 mesh=None):
        from types import SimpleNamespace

        from aiko_services_tpu_torch.observe.ledger import KVMemoryLedger
        from aiko_services_tpu_torch.process import ProcessRuntime
        from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                     PrefixKVCache)
        from aiko_services_tpu_torch.serving_disagg import SessionMigrator
        from aiko_services_tpu_torch.serving_tiered import HostBlockStore
        from aiko_services_tpu_torch.state.sessions import SessionTable
        from aiko_services_tpu_torch.transport import MemoryMessage

        def transport(on_message, lwt_topic, lwt_payload, lwt_retain):
            return MemoryMessage(on_message=on_message, broker=broker,
                                 lwt_topic=lwt_topic,
                                 lwt_payload=lwt_payload,
                                 lwt_retain=lwt_retain, client_id=name)
        self.engine = engine
        self.rt = ProcessRuntime(name=name, engine=engine,
                                 transport_factory=transport).initialize()
        block = MIGRATE["block"]
        self.cache = PrefixKVCache(block_tokens=block, max_bytes=512 << 20,
                                   name=name)
        if host_mb:
            self.cache.attach_host_store(HostBlockStore(
                max_bytes=host_mb << 20, name=f"{name}.host"))
        self.decoder = ContinuousDecoder(
            params, config, paged_kv=True, kv_block=block,
            prefix_cache=self.cache, max_slots=MIGRATE["sessions"],
            prefill_buckets=(128,), prefill_chunk=128, steps_per_sync=4,
            name=name, mesh=mesh)
        self.ledger = KVMemoryLedger(name=name)
        self.decoder.attach_ledger(self.ledger)
        self.table = SessionTable(
            SimpleNamespace(runtime=self.rt, topic_path=self.rt.topic_path),
            num_shards=1)
        self.mig = SessionMigrator(self.rt, self.cache, table=self.table,
                                   name=name,
                                   chunk_blocks=MIGRATE["chunk_blocks"],
                                   transfer_timeout=60.0,
                                   decoder=self.decoder if mesh is not None
                                   else None)
        engine.add_flatout_handler(self.decoder.pump)

    def turns(self, prompts: dict, new: int) -> dict:
        """Every prompt at once; {sid: generated tokens}."""
        done = {}
        for sid, prompt in prompts.items():
            self.decoder.submit(sid, prompt, new, lambda rid, t: done.update(
                {rid: [int(x) for x in t]}))
        if not self.engine.run_until(lambda: len(done) == len(prompts),
                                     timeout=300.0):
            raise AssertionError(f"{len(done)} of {len(prompts)} turns")
        return done

    def store(self, sid, history) -> int:
        leaf, kv_tokens = self.cache.session_store("default", sid, history)
        if not self.table.create("default", sid, {
                "history": history, "kv": leaf or "",
                "kv_tokens": kv_tokens}):
            raise AssertionError(f"session {sid} shed")
        return kv_tokens

    def stop(self) -> None:
        self.mig.stop()
        self.table.stop()
        self.engine.remove_flatout_handler(self.decoder.pump)
        self.rt.terminate()


def migrate_run(config, params, seed: int, mesh=None,
                watch_syncs: bool = False) -> dict:
    """MIGRATE["sessions"] sessions x 2 turns on side A (a host tier of
    MIGRATE["host_mb"] MiB), every session demoted, migrated to side B in
    chunks of MIGRATE["chunk_blocks"] blocks, A purged; then turn 3 on
    B.  With `mesh` B's decoder and cache are on it (its migrator lands
    at the decoder's note); with watch_syncs the migration runs under
    torch's sync debug mode, and the record counts the calls that
    synchronized.  Returns the run's record (histories and turn-3 tokens
    too)."""
    import numpy as np

    from aiko_services_tpu_torch.event import EventEngine
    from aiko_services_tpu_torch.observe.ledger import assert_ledger_clean
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.transport import MemoryBroker

    rng = np.random.default_rng(seed)
    engine, broker = EventEngine(), MemoryBroker()
    sides = SideLaunches()
    a = MigrateSide(engine, broker, params, config, "migrate_a",
                    host_mb=MIGRATE["host_mb"])
    b = MigrateSide(engine, broker, params, config, "migrate_b", mesh=mesh)
    extends = [count_extend_launches(a.decoder),
               count_extend_launches(b.decoder)]
    try:
        for name in P.launches:
            P.launches[name] = 0
        prompts = {f"s{i}": rng.integers(1, config.vocab, int(n)).tolist()
                   for i, n in enumerate(rng.integers(
                       *MIGRATE["prompt_tokens"], MIGRATE["sessions"]))}
        histories, pinned = {}, {}
        for turn in range(2):
            out = a.turns(prompts, MIGRATE["new"])
            for sid, prompt in prompts.items():
                histories[sid] = prompt + out[sid]
                pinned[sid] = a.store(sid, histories[sid])
            if turn == 0:
                prompts = {sid: history + rng.integers(
                    1, config.vocab, MIGRATE["turn_tokens"]).tolist()
                    for sid, history in histories.items()}
        demoted = a.cache.demote_sessions(a.cache.sessions())
        done = []
        with sync_watch(arm=watch_syncs) as syncs:
            offers = a.mig.migrate(b.mig.topic,
                                   on_done=lambda m: done.append(1))
            if not engine.run_until(lambda: bool(done), timeout=120.0):
                raise AssertionError("the migration never settled")
        a_stats, b_stats = dict(a.mig.stats), dict(b.mig.stats)
        a.cache.purge(demote=False)
        a_left = (len(a.table), a.cache.sessions(),
                  a.decoder.pool.used_blocks())
        assert_ledger_clean(cache=a.cache, ledger=a.ledger)
        hits_before = b.cache.stats["hit_tokens"]
        third = {sid: history + rng.integers(
            1, config.vocab, MIGRATE["turn_tokens"]).tolist()
            for sid, history in histories.items()}
        admits_before = b.decoder.stats["prefix_admits"]
        out3 = b.turns(third, MIGRATE["new"])
        hit = b.cache.stats["hit_tokens"] - hits_before
        b_audit = b.ledger.audit()
        torch.cuda.synchronize()
        launches = dict(P.launches)
        b.cache.release_sessions(b.cache.sessions())
        b.cache.purge(demote=False)
        assert_ledger_clean(cache=b.cache, ledger=b.ledger)
        return {"offers": offers, "demoted": demoted, "a": a_stats,
                "b": b_stats, "a_left": a_left, "pinned": pinned,
                "hit_tokens": hit, "prefix_admits":
                b.decoder.stats["prefix_admits"] - admits_before,
                "b_audit": b_audit, "third": third, "out3": out3,
                "migrate_out": a.ledger.stats["migrate_out"],
                "migrate_in": b.ledger.stats["migrate_in"],
                "launches": launches, "syncs": dict(syncs),
                "agreed": b.mig.agreed, "b_pending": b.mig.pending_count(),
                "by_side": {"a": sides.by_decoder[a.decoder],
                            "b": sides.by_decoder[b.decoder]},
                "extends": [extends[0][:], extends[1][:]]}
    finally:
        sides.close()
        a.stop()
        b.stop()


def migrate_counts(run: dict, label: str) -> dict:
    """A migrate_run's counts, checked: offers = migrated = the sessions,
    none expired or dropped, shipped = installed blocks = the pinned
    chains' (no handles: B is cold), A's sessions and pool at 0, both
    ledgers clean, MIGRATE_LAUNCHES paged launches, every turn-3 chain a
    prefix hit of the pinned tokens."""
    pinned_blocks = sum(run["pinned"].values()) // MIGRATE["block"]
    sessions = MIGRATE["sessions"]
    got = {"offers": run["a"]["offers"], "migrated": run["a"]["migrated"],
           "expired": run["a"]["expired"] + run["b"]["expired"],
           "dropped": run["b"]["dropped_chunks"],
           "shipped_blocks": run["a"]["shipped_blocks"],
           "handle_blocks": run["a"]["handle_blocks"],
           "installed_blocks": run["b"]["installed_blocks"]}
    want = {"offers": sessions, "migrated": sessions, "expired": 0,
            "dropped": 0, "shipped_blocks": pinned_blocks,
            "handle_blocks": 0, "installed_blocks": pinned_blocks}
    if got != want or run["a_left"] != (0, [], 0) or run["b_audit"] or \
            sum(run["launches"].values()) != MIGRATE_LAUNCHES or \
            run["hit_tokens"] != sum(run["pinned"].values()) or \
            run["prefix_admits"] != sessions or \
            run["migrate_out"] != pinned_blocks or \
            run["migrate_in"] != pinned_blocks or not run["demoted"]:
        raise AssertionError(
            f"{label}: {got} (want {want}), source left "
            f"{run['a_left']}, B audit {run['b_audit']}, hit "
            f"{run['hit_tokens']} of {sum(run['pinned'].values())}, "
            f"{run['prefix_admits']} admits, ledger events "
            f"{run['migrate_out']} / {run['migrate_in']}, launches "
            f"{sum(run['launches'].values())}")
    return got


def migrate_f32(label: str, mesh=None) -> dict:
    """migrate_run at 2 layers in f32 (B over `mesh` when given): every
    session's turn 3 on B against llama_greedy_decode on its whole
    history (greedy_check's tie rule)."""
    from aiko_services_tpu_torch.models.llama import llama_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = disagg_config(num_layers=2, dtype=torch.float32)
    params = llama_init(torch.Generator(device="cuda").manual_seed(5),
                        small)
    run = migrate_run(small, params, MIGRATE["seed"], mesh=mesh)
    ties, identical = [], 0
    for sid, prompt in run["third"].items():
        tie = greedy_check(params, small, prompt, run["out3"][sid],
                           f"{label} {sid}")
        identical += tie is None
        if tie is not None:
            ties.append(tie)
    sessions = MIGRATE["sessions"]
    if run["a"]["migrated"] != sessions or \
            run["prefix_admits"] != sessions:
        raise AssertionError(f"{label} f32: {run['a']}, "
                             f"{run['prefix_admits']} admits")
    del params
    torch.cuda.empty_cache()
    return {"sessions": sessions, "identical": identical, "ties": ties}


def migrate_record(run: dict, got: dict) -> dict:
    return {**got, "pinned_tokens": sum(run["pinned"].values()),
            "hit_tokens": run["hit_tokens"],
            "demoted_blocks": run["demoted"],
            "chunks": run["a"]["chunks"],
            "migrate_events": [run["migrate_out"], run["migrate_in"]],
            "paged_launches_by_side": run["by_side"],
            "extends": run["extends"],
            "paged_launches": sum(run["launches"].values())}


def migrate_launches(run: dict) -> dict:
    """A migrate_run's paged launches by (variant, path): prefill chunks
    of 128, so the extends run at the agent's 512-row shape."""
    launches = sum(run["launches"].values())
    extend = run["extends"][0][1] + run["extends"][1][1]
    return {("paged_decode_attention", "decode"): launches - extend,
            ("paged_decode_attention", "extend_512"): extend}


def phase_agent_migrate() -> tuple:
    """Two serving sides (decoder, prefix cache, session table,
    SessionMigrator) on Llama-1B bf16 sharing one set of parameters,
    side A with a 512 MB host tier: 8 sessions x 2 turns on A, every
    session demoted, migrated to B in chunks of 8 blocks (the chains
    promote back before they ship), A purged; turn 3 on B.  Checks:
    migrate_counts; at 2 layers in f32, B's turn 3 against
    llama_greedy_decode on the whole history.  Returns the paged
    launches by (variant, path) and turn 3's tokens."""
    from aiko_services_tpu_torch.models.llama import llama_init

    config = disagg_config()
    check_1b(config)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    start = time.perf_counter()
    run = migrate_run(config, params, MIGRATE["seed"])
    wall = time.perf_counter() - start
    got = migrate_counts(run, "agent_migrate")
    del params
    torch.cuda.empty_cache()
    emit({"phase": "agent_migrate", **migrate_record(run, got),
          "wall_s": wall, "f32": migrate_f32("migrated")})
    return migrate_launches(run), run["out3"]


def phase_agent_migrate_mesh(reference: dict) -> dict:
    """agent_migrate's drive with side B's decoder and prefix cache on
    create_mesh({"model": 1}): B's SessionMigrator takes each offer,
    install and landing at its decoder's round note.  Checks: every
    count of migrate_counts (agent_migrate's), turn 3's tokens equal
    agent_migrate's (`reference`), no call synchronizes the stream while
    the sessions migrate (torch's sync debug mode), and at 2 layers in
    f32 every turn 3 identical to llama_greedy_decode.  Returns the
    paged launches by (variant, path)."""
    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.parallel import create_mesh

    mesh = create_mesh({"model": 1})
    config = disagg_config()
    check_1b(config)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    start = time.perf_counter()
    run = migrate_run(config, params, MIGRATE["seed"], mesh=mesh,
                      watch_syncs=True)
    wall = time.perf_counter() - start
    got = migrate_counts(run, "agent_migrate_mesh")
    del params
    torch.cuda.empty_cache()
    if run["syncs"] or not run["agreed"] or run["b_pending"] or \
            run["out3"] != reference:
        differing = sorted(sid for sid in reference
                           if run["out3"].get(sid) != reference[sid])
        raise AssertionError(
            f"agent_migrate_mesh: syncs {run['syncs']}, agreed "
            f"{run['agreed']}, {run['b_pending']} pending at B, turn 3 "
            f"differs from agent_migrate in {differing}")
    f32 = migrate_f32("migrated on the mesh", mesh=mesh)
    if f32["identical"] != f32["sessions"]:
        raise AssertionError(f"agent_migrate_mesh f32: {f32}")
    emit({"phase": "agent_migrate_mesh", "mesh": {"model": 1},
          **migrate_record(run, got), "syncs": 0,
          "tokens_equal_agent_migrate": True, "wall_s": wall,
          "f32": f32})
    return migrate_launches(run)


# -- the parallel substrate and the training path ------------------------------

# train: Whisper-small at its published widths (12 + 12 layers, 768 wide,
# 12 heads, vocabulary 51,865, audio context 1500 from 3000 mel frames),
# f32 parameters, AdamW with optax's defaults at a fine-tuning rate, a
# batch of 4 with 64 target tokens, 5 steps on that one batch
TRAIN = {"batch": 4, "tokens": 64, "frames": 3000, "steps": 5, "lr": 1e-4}
# train_f32 and checkpoint: the widths at 2 + 2 layers and context 500
# (1000 frames), a batch of 2 with 32 target tokens
TRAIN_SMALL = {"batch": 2, "tokens": 32, "frames": 1000, "layers": 2}
# train_f32: the card's 3 steps against the CPU's, TF32 off.  The losses
# agree within TRAIN_F32_LOSS_RTOL.  Adam's normalised update
# m / (sqrt(v) + eps) turns the rounding of a gradient near zero into up
# to a whole step lr in either direction for that element (the first
# chip run measured one element 0.385 of a step apart after 3 steps, 739
# of 75,209,472 over a hundredth of a step), so each element is held
# within TRAIN_F32_STEP_SHARE of one step, and the update as a whole
# (parameters after minus before, every tensor) within
# TRAIN_F32_UPDATE_REL_L2 relative L2 of the CPU's (measured 5.45e-5)
TRAIN_F32_LOSS_RTOL = 1e-5
TRAIN_F32_STEP_SHARE = 1.0
TRAIN_F32_UPDATE_REL_L2 = 2e-4
# checkpoint: the resumed run against the uninterrupted one, on one card:
# JAX's test holds rtol 1e-6
CHECKPOINT_RTOL = 1e-6
# sp_prefill: Llama-1B in bf16 at 2048 tokens (argmax agreement with the
# plain forward at least SP_ARGMAX_MIN: the ring keeps its probabilities
# in f32 where the plain path rounds them to bf16, and random weights
# put many positions at near-ties: the first chip run agreed at 0.955),
# and at 2 layers in f32 (logits within SP_F32_TOL, the CPU test's and
# JAX's own limit; measured 2.5e-5)
SP_TOKENS = 2048
SP_ARGMAX_MIN = 0.9
SP_F32_TOL = 2e-4
# staged: Whisper-small in bf16 at bucket 3072 (context 1536: the flash
# kernel's shape in the slice phase), 3 batches of 8, 24 tokens each
STAGED = {"batches": 3, "batch": 8, "frames": 3072, "max_tokens": 24}
STAGED_FLASH = 12 * 3


def whisper_loss(config):
    from aiko_services_tpu_torch.models.whisper import forward
    from aiko_services_tpu_torch.parallel.train import cross_entropy_loss

    def loss_fn(params, batch):
        logits = forward(params, config, batch["mel"], batch["tokens"])
        return cross_entropy_loss(logits, batch["targets"])
    return loss_fn


def train_batch(config, shape: dict, seed: int, device) -> dict:
    """Seeded mel frames and token sequences (targets the next token)."""
    generator = torch.Generator(device=device).manual_seed(seed)
    mel = torch.randn((shape["batch"], shape["frames"], config.n_mels),
                      generator=generator, device=device)
    seq = torch.randint(0, config.n_vocab,
                        (shape["batch"], shape["tokens"] + 1),
                        generator=generator, device=device)
    return {"mel": mel, "tokens": seq[:, :-1], "targets": seq[:, 1:]}


def run_steps(state, step, batch, steps: int) -> tuple:
    """(state, losses, seconds of each step, each ending in the host's
    read of its loss)."""
    losses, seconds = [], []
    for _ in range(steps):
        start = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - start)
    return state, losses, seconds


def small_whisper(**changes):
    from aiko_services_tpu_torch.models.whisper import WHISPER_PRESETS
    return dataclasses.replace(
        WHISPER_PRESETS["small"], enc_layers=TRAIN_SMALL["layers"],
        dec_layers=TRAIN_SMALL["layers"],
        n_audio_ctx=TRAIN_SMALL["frames"] // 2, **changes)


def phase_train() -> dict:
    """Whisper-small AdamW steps through init_train_state /
    make_train_step on a one-rank NCCL mesh."""
    import torch.distributed as dist

    from aiko_services_tpu_torch.models.whisper import (
        WHISPER_PRESETS, whisper_axes, whisper_init)
    from aiko_services_tpu_torch.ops import attention as A
    from aiko_services_tpu_torch.parallel import (
        create_mesh, init_train_state, make_train_step)
    from aiko_services_tpu_torch.parallel.train import adamw

    config = WHISPER_PRESETS["small"]
    if (config.dim, config.num_heads, config.enc_layers, config.dec_layers,
            config.n_vocab, config.n_audio_ctx) != \
            (*WHISPER_SMALL, 1500) or config.dtype != torch.float32:
        raise AssertionError(f"not Whisper-small in f32: {config}")
    mesh = create_mesh({"data": 1})
    if dist.get_backend() != "nccl" or mesh.size() != 1 or \
            mesh.device_type != "cuda":
        raise AssertionError(f"mesh {mesh} on {dist.get_backend()}")
    # the phase's own memory: what earlier phases left allocated is
    # subtracted from the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    model = whisper_init(torch.Generator(device="cuda").manual_seed(0),
                         config)
    parameters = sum(p.numel() for p in model.parameters())
    batch = train_batch(config, TRAIN, 1, "cuda")
    state = init_train_state(model, adamw(TRAIN["lr"]), mesh,
                             whisper_axes(config))
    step = make_train_step(whisper_loss(config), mesh=mesh)
    zero_attention_counts()
    dispatch_before = dict(A.dispatch_stats)
    state, losses, seconds = run_steps(state, step, batch, TRAIN["steps"])
    counts = attention_counts()
    if not all(math.isfinite(loss) for loss in losses) or \
            not losses[-1] < losses[0] or state.step != TRAIN["steps"]:
        raise AssertionError(f"train: losses {losses}, step {state.step}")
    if any(counts.values()):
        raise AssertionError(f"train launched kernels: {counts}")
    step_s = statistics.median(seconds[1:])
    record = {"phase": "train", "parameters": parameters,
              "batch": TRAIN["batch"], "target_tokens": TRAIN["tokens"],
              "audio_ctx": config.n_audio_ctx, "lr": TRAIN["lr"],
              "losses": losses, "step": state.step,
              "first_step_s": seconds[0], "ms_per_step": step_s * 1e3,
              "target_tokens_per_s": TRAIN["batch"] * TRAIN["tokens"] /
              step_s,
              "peak_memory_gb": (torch.cuda.max_memory_allocated() -
                                 before) / 1e9,
              "allocated_before_gb": before / 1e9,
              "flash_launches": counts["flash_attention"],
              "attention_dispatch": {
                  key: A.dispatch_stats[key] - dispatch_before[key]
                  for key in dispatch_before},
              "mesh": {"data": 1, "backend": dist.get_backend()}}
    emit(record)
    del state, model, step
    torch.cuda.empty_cache()
    return record


def phase_train_f32() -> dict:
    """A 2-layer Whisper at Whisper-small's widths: 3 AdamW steps on the
    card against the same 3 steps of the port on the CPU, in f32."""
    import copy

    from aiko_services_tpu_torch.models.whisper import whisper_init
    from aiko_services_tpu_torch.parallel import (
        init_train_state, make_train_step)
    from aiko_services_tpu_torch.parallel.train import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = small_whisper()
    cpu_model = whisper_init(torch.Generator().manual_seed(3), config,
                             device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    before = [p.detach().clone() for p in cpu_model.parameters()]
    cpu_batch = train_batch(config, TRAIN_SMALL, 4, "cpu")
    card_batch = {key: value.cuda() for key, value in cpu_batch.items()}
    runs = {}
    for device, model, batch in (("cuda", card_model, card_batch),
                                 ("cpu", cpu_model, cpu_batch)):
        state = init_train_state(model, adamw(TRAIN["lr"]))
        step = make_train_step(whisper_loss(config))
        zero_attention_counts()
        start = time.perf_counter()
        state, losses, _ = run_steps(state, step, batch, 3)
        runs[device] = (state, losses, time.perf_counter() - start,
                        attention_counts())
    card, cpu = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
    gap, worst, diff_sq, update_sq, over = 0.0, None, 0.0, 0.0, 0
    for (name, p), q, p0 in zip(card[0].params.named_parameters(),
                                cpu[0].params.parameters(), before):
        diff = (p.detach().cpu() - q.detach()).abs()
        over += int((diff > 0.01 * TRAIN["lr"]).sum())
        diff_sq += float((diff.double() ** 2).sum())
        update_sq += float(((q.detach() - p0).double() ** 2).sum())
        if diff.max().item() > gap:
            gap, worst = diff.max().item(), name
    share = gap / TRAIN["lr"]
    update_rel_l2 = math.sqrt(diff_sq / update_sq)
    if loss_rel > TRAIN_F32_LOSS_RTOL or share > TRAIN_F32_STEP_SHARE or \
            update_rel_l2 > TRAIN_F32_UPDATE_REL_L2 or \
            any(card[3].values()):
        raise AssertionError(f"train_f32: losses {card[1]} vs {cpu[1]} "
                             f"(rel {loss_rel}), parameter gap {gap} = "
                             f"{share} of a step at {worst}, update rel "
                             f"L2 {update_rel_l2}, launches {card[3]}")
    record = {"phase": "train_f32", "layers": TRAIN_SMALL["layers"],
              "losses_card": card[1], "losses_cpu": cpu[1],
              "loss_max_rel": loss_rel, "param_max_abs": gap,
              "param_max_abs_in_steps": share, "worst": worst,
              "step_share_limit": TRAIN_F32_STEP_SHARE,
              "update_rel_l2": update_rel_l2,
              "update_rel_l2_limit": TRAIN_F32_UPDATE_REL_L2,
              "elements_over_a_hundredth_step": over,
              "elements": sum(p.numel() for p in before),
              "card_s": card[2], "cpu_s": cpu[2]}
    emit(record)
    return record


def whisper_mesh_loss(config, mesh):
    """whisper_loss on a model axis: the forward and the vocab-parallel
    loss called with the mesh (a rank's shards; at one rank the model)."""
    from aiko_services_tpu_torch.models.whisper import forward
    from aiko_services_tpu_torch.parallel.train import cross_entropy_loss

    def loss_fn(params, batch):
        logits = forward(params, config, batch["mel"], batch["tokens"],
                         mesh=mesh)
        return cross_entropy_loss(logits, batch["targets"], mesh=mesh)
    return loss_fn


def phase_train_mesh() -> dict:
    """train_f32's 2-layer Whisper at Whisper-small's widths: 3 AdamW
    steps on the card unsharded (whisper_loss, no mesh), and 3 on a
    one-rank NCCL mesh {model: 1} with the parameters placed by
    whisper_axes and the forward and vocab-parallel loss called with the
    mesh, in f32 from the same start and batch.  A model axis of one rank
    computes as unsharded, the same launches and products; the one
    nondeterminism is the card's embedding backward (an atomic
    scatter-add of repeated tokens), so the two runs are held to
    train_f32's limits of the card against the CPU, and whether they
    came out bit-equal is recorded."""
    import copy

    import torch.distributed as dist

    from aiko_services_tpu_torch.models.whisper import (whisper_axes,
                                                        whisper_init)
    from aiko_services_tpu_torch.parallel import (
        create_mesh, init_train_state, make_train_step)
    from aiko_services_tpu_torch.parallel.train import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = small_whisper()
    mesh = create_mesh({"model": 1})
    if dist.get_backend() != "nccl" or mesh.size() != 1:
        raise AssertionError(f"mesh {mesh} on {dist.get_backend()}")
    model = whisper_init(torch.Generator(device="cuda").manual_seed(5),
                         config)
    batch = train_batch(config, TRAIN_SMALL, 6, "cuda")
    start_params = [p.detach().clone() for p in model.parameters()]
    runs = {}
    for label, start, on, axes in (
            ("unsharded", copy.deepcopy(model), None, None),
            ("mesh", model, mesh, whisper_axes(config))):
        state = init_train_state(start, adamw(TRAIN["lr"]), on, axes)
        step = make_train_step(whisper_mesh_loss(config, on), mesh=on)
        zero_attention_counts()
        began = time.perf_counter()
        state, losses, _ = run_steps(state, step, batch, 3)
        runs[label] = (state, losses, time.perf_counter() - began,
                       attention_counts())
    plain, meshed = runs["unsharded"], runs["mesh"]
    gap, worst, diff_sq, update_sq = 0.0, None, 0.0, 0.0
    for (name, p), q, p0 in zip(meshed[0].params.named_parameters(),
                                plain[0].params.parameters(),
                                start_params):
        diff = (p.detach() - q.detach()).abs()
        diff_sq += float((diff.double() ** 2).sum())
        update_sq += float(((q.detach() - p0).double() ** 2).sum())
        if diff.max().item() > gap:
            gap, worst = diff.max().item(), name
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(meshed[1], plain[1]))
    update_rel_l2 = math.sqrt(diff_sq / update_sq)
    if loss_rel > TRAIN_F32_LOSS_RTOL or \
            gap / TRAIN["lr"] > TRAIN_F32_STEP_SHARE or \
            update_rel_l2 > TRAIN_F32_UPDATE_REL_L2 or \
            not meshed[1][-1] < meshed[1][0] or meshed[3] != plain[3]:
        raise AssertionError(f"train_mesh: losses {meshed[1]} vs "
                             f"{plain[1]} (rel {loss_rel}), parameter gap "
                             f"{gap} at {worst}, update rel L2 "
                             f"{update_rel_l2}, launches {meshed[3]} vs "
                             f"{plain[3]}")
    record = {"phase": "train_mesh", "layers": TRAIN_SMALL["layers"],
              "mesh": {"model": 1, "backend": dist.get_backend()},
              "losses": meshed[1], "losses_unsharded": plain[1],
              "loss_max_rel": loss_rel, "param_max_abs": gap,
              "param_max_abs_in_steps": gap / TRAIN["lr"],
              "update_rel_l2": update_rel_l2, "worst": worst,
              "bit_equal": gap == 0.0 and meshed[1] == plain[1],
              "mesh_s": meshed[2], "unsharded_s": plain[2]}
    emit(record)
    del runs, model
    torch.cuda.empty_cache()
    return record


def phase_checkpoint() -> dict:
    """On the card: 3 steps, save, 2 more; a fresh state restored from the
    save and run 2 steps must equal the uninterrupted run."""
    from aiko_services_tpu_torch.models.whisper import whisper_init
    from aiko_services_tpu_torch.parallel import (
        TrainState, init_train_state, make_train_step, restore_checkpoint,
        save_checkpoint)
    from aiko_services_tpu_torch.parallel.train import adamw

    # the two runs must repeat each other's arithmetic: cuDNN's
    # deterministic convolution algorithms (cuBLAS's products repeat)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _checkpoint_runs()
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _checkpoint_runs() -> dict:
    from aiko_services_tpu_torch.models.whisper import whisper_init
    from aiko_services_tpu_torch.parallel import (
        TrainState, init_train_state, make_train_step, restore_checkpoint,
        save_checkpoint)
    from aiko_services_tpu_torch.parallel.train import adamw

    config = small_whisper()
    batch = train_batch(config, TRAIN_SMALL, 5, "cuda")
    step = make_train_step(whisper_loss(config))

    def fresh(seed):
        return init_train_state(whisper_init(
            torch.Generator(device="cuda").manual_seed(seed), config),
            adamw(TRAIN["lr"]))

    state, _, _ = run_steps(fresh(6), step, batch, 3)
    with tempfile.TemporaryDirectory() as directory:
        start = time.perf_counter()
        path = save_checkpoint(directory, {
            "params": state.params, "opt_state": state.opt_state,
            "step": int(state.step)}, step=int(state.step))
        save_s = time.perf_counter() - start
        nbytes = os.path.getsize(os.path.join(path, "state.npz"))
        with open(os.path.join(path, "manifest.json")) as handle:
            manifest = json.load(handle)
        state, _, _ = run_steps(state, step, batch, 2)
        template = fresh(7)
        start = time.perf_counter()
        loaded = restore_checkpoint(path, {
            "params": template.params, "opt_state": template.opt_state,
            "step": 0})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - start
    resumed = TrainState(loaded["params"], loaded["opt_state"],
                         loaded["step"])
    resumed, _, _ = run_steps(resumed, step, batch, 2)
    worst = 0.0
    for p, q in zip(state.params.parameters(), resumed.params.parameters()):
        for a, b in ((p, q), (state.opt_state.state[p]["exp_avg"],
                              resumed.opt_state.state[q]["exp_avg"]),
                     (state.opt_state.state[p]["exp_avg_sq"],
                      resumed.opt_state.state[q]["exp_avg_sq"])):
            rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
            worst = max(worst, rel)
    if worst > CHECKPOINT_RTOL or not resumed.step == state.step == 5:
        raise AssertionError(f"checkpoint: resumed run differs (max rel "
                             f"{worst}), steps {resumed.step} / "
                             f"{state.step}")
    record = {"phase": "checkpoint", "leaves": manifest["leaves"],
              "manifest_step": manifest["step"], "npz_bytes": nbytes,
              "save_s": save_s, "restore_s": restore_s,
              "max_rel_diff": worst, "rtol": CHECKPOINT_RTOL,
              "step": resumed.step}
    emit(record)
    return record


def phase_sp_prefill() -> dict:
    """llama_forward_sp on a one-rank seq mesh against llama_forward:
    Llama-1B in bf16 (argmax agreement) and at 2 layers in f32."""
    from aiko_services_tpu_torch.models.llama import (
        LLAMA_PRESETS, llama_forward, llama_forward_sp, llama_init)
    from aiko_services_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh({"seq": 1})
    record = {"phase": "sp_prefill", "tokens": SP_TOKENS}
    for label, changes in (("bf16", {"dtype": torch.bfloat16}),
                           ("f32", {"num_layers": 2})):
        config = dataclasses.replace(LLAMA_PRESETS["1b"], **changes)
        params = llama_init(torch.Generator(device="cuda").manual_seed(8),
                            config)
        tokens = torch.randint(
            0, config.vocab, (1, SP_TOKENS), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(9))
        zero_attention_counts()
        with torch.no_grad():
            start = time.perf_counter()
            sp = llama_forward_sp(params, config, tokens, mesh).to_local()
            torch.cuda.synchronize()
            sp_s = time.perf_counter() - start
            start = time.perf_counter()
            plain = llama_forward(params, config, tokens)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - start
        counts = attention_counts()
        if sp.shape != plain.shape or not torch.isfinite(sp).all() or \
                any(counts.values()):
            raise AssertionError(f"sp_prefill {label}: shape "
                                 f"{tuple(sp.shape)}, launches {counts}")
        split = sp.argmax(-1) != plain.argmax(-1)
        agreement = 1.0 - split.float().mean().item()
        err = (sp - plain).abs().max().item()
        # the plain forward's top-2 logit gap where the two split
        top2 = torch.topk(plain[split], 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).sort().values.tolist()
        record[label] = {"layers": config.num_layers,
                         "argmax_agreement": agreement, "max_abs_err": err,
                         "split_gap_median": statistics.median(gaps)
                         if gaps else None,
                         "split_gap_max": max(gaps) if gaps else None,
                         "sp_s": sp_s, "plain_s": plain_s}
        if label == "bf16" and agreement < SP_ARGMAX_MIN:
            raise AssertionError(f"sp_prefill bf16: argmax agreement "
                                 f"{agreement} < {SP_ARGMAX_MIN}")
        if label == "f32" and not torch.allclose(sp, plain, rtol=SP_F32_TOL,
                                                 atol=SP_F32_TOL):
            raise AssertionError(f"sp_prefill f32: max abs err {err}")
        del params, sp, plain
        torch.cuda.empty_cache()
    emit(record)
    return record


def phase_staged() -> int:
    """StagedExecutor([encode, greedy_decode_from_audio]) on one card's
    two stages: tokens equal to the unstaged program's; returns the
    flash launches of the staged run."""
    from aiko_services_tpu_torch.models.whisper import (
        WHISPER_PRESETS, encode, greedy_decode_from_audio,
        greedy_decode_scored, whisper_init)
    from aiko_services_tpu_torch.parallel import StagedExecutor

    base = WHISPER_PRESETS["small"]
    # the slice phase's element config at bucket 3072
    config = dataclasses.replace(
        base, n_audio_ctx=STAGED["frames"] // 2,
        n_text_ctx=STAGED["max_tokens"] + 8, dtype=torch.bfloat16)
    params = whisper_init(torch.Generator(device="cuda").manual_seed(0),
                          config)
    kwargs = {"max_tokens": STAGED["max_tokens"],
              "suppress_timestamps": True}

    @torch.inference_mode()
    def stage_encode(p, mel):
        return encode(p, config, mel)

    def stage_decode(p, audio):
        return greedy_decode_from_audio(p, config, audio, **kwargs)

    encoder = {k: params[k] for k in ("conv1", "conv2", "enc_blocks",
                                      "ln_enc")}
    decoder = {k: params[k] for k in ("tok_embed", "pos_embed",
                                      "dec_blocks", "ln_dec")}
    card = torch.device("cuda", 0)
    executor = StagedExecutor([(stage_encode, encoder),
                               (stage_decode, decoder)],
                              devices=[card, card])
    generator = torch.Generator(device="cuda").manual_seed(10)
    mels = [torch.randn((STAGED["batch"], STAGED["frames"], config.n_mels),
                        generator=generator, device="cuda").to(config.dtype)
            for _ in range(STAGED["batches"])]
    torch.cuda.synchronize()
    zero_attention_counts()
    # submit() must queue the stages without a host wait: under sync
    # debug mode "error" any synchronizing call in it raises
    sync_mode = torch.cuda.get_sync_debug_mode()
    with flash_shapes() as shapes:
        start = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = [executor.submit(mel) for mel in mels]
        finally:
            torch.cuda.set_sync_debug_mode(sync_mode)
        submit_s = time.perf_counter() - start
        queued = torch.cuda.Event()
        queued.record()
        busy_at_return = not queued.query()
        in_flight = executor.in_flight
        staged = [executor.collect(y) for y in pending]
        total_s = time.perf_counter() - start
    counts = attention_counts()
    flash_shape = check_flash_shapes("staged", shapes.seen)
    if in_flight != STAGED["batches"] or executor.in_flight != 0 or \
            counts["flash_attention"] != STAGED_FLASH:
        raise AssertionError(f"staged: in flight {in_flight} then "
                             f"{executor.in_flight}, launches {counts}")
    identical = 0
    for mel, (tokens, lengths, scores) in zip(mels, staged):
        ref = greedy_decode_scored(params, config, mel, **kwargs)
        if not (torch.equal(torch.from_numpy(tokens), ref[0].cpu()) and
                torch.equal(torch.from_numpy(lengths), ref[1].cpu())):
            raise AssertionError("staged tokens differ from the unstaged "
                                 "program's")
        identical += 1
    emit({"phase": "staged", "batches": STAGED["batches"],
          "batch": STAGED["batch"], "identical_batches": identical,
          "in_flight_peak": in_flight, "in_flight_after": executor.in_flight,
          "flash_launches": counts["flash_attention"],
          "flash_shape": flash_shape, "submit_s": submit_s,
          "total_s": total_s,
          "device_busy_at_submit_return": busy_at_return})
    return counts["flash_attention"]


# operator_scripts: the counts each drive must show, from the CPU
# rehearsal (tools/chip_rehearsal.py operator_scripts; the soak's from a
# CPU run of the same seed, the migrate soak's and disagg_smoke's with
# the 1b preset a 64-wide 16-layer stand-in: their schedules depend on
# neither widths nor token values).  The migrate soak's paged launches
# are 16 layers x the decode steps and extends of its rounds.
OPERATOR_SCRIPTS = {
    "soak": {"frames_sent": 8, "frames_recovered": 8, "frames_lost": 0,
             "texts_returned": 8, "pending_hops": 0, "leaked_hop_leases": 0,
             "faults_injected": {"duplicate": 9, "drop": 3, "delay": 3,
                                 "partitioned": 4}},
    "migrate": {"paged_launches": 16 * 55, "partial_tokens": 9,
                "rounds": 32,
                "shipped_blocks": 12, "installed_blocks": 12,
                "prefix_hit_tokens": 48},
    "disagg": {"transfers": 10, "handle_hit_rate": 0.1839,
               "paged_launches": 0},
    "disagg_window": 0.2,
    # disagg_smoke serves Llama-1B's widths at 4 of its 16 layers: its
    # transfers (each block's K/V of every layer, f32) took 10.7 s of
    # its ~12-16 s at full depth, and it launches no attention kernel
    "disagg_layers": 4,
}


def phase_operator_scripts() -> int:
    """The port's operator scripts on the card through their entry
    points, each drive with every attention count zeroed before it and
    read after it: chaos_soak.run_soak at the CLI's defaults,
    chaos_soak.run_migrate_soak(preset="1b") and disagg_smoke.run on
    Llama-1B cut to OPERATOR_SCRIPTS' layers, with its window.  Checks each report's
    verdicts and OPERATOR_SCRIPTS' counts; returns the attention launches
    of the three drives."""
    from aiko_services_tpu_torch.scripts import chaos_soak, disagg_smoke

    expected = OPERATOR_SCRIPTS
    zero_attention_counts()
    start = time.perf_counter()
    soak = chaos_soak.run_soak(seed=11, frames=8)
    soak_s = time.perf_counter() - start
    soak_launches = sum(attention_counts().values())
    got = {key: soak[key] for key in expected["soak"]}
    if got != expected["soak"] or soak_launches:
        raise AssertionError(f"operator_scripts soak: {got} != "
                             f"{expected['soak']}, {soak_launches} "
                             f"attention launches")

    zero_attention_counts()
    start = time.perf_counter()
    migrate = chaos_soak.run_migrate_soak(seed=11, preset="1b")
    migrate_s = time.perf_counter() - start
    migrate_launches = sum(attention_counts().values())
    torch.cuda.empty_cache()
    got = {"paged_launches": migrate_launches,
           "partial_tokens": migrate["victim"]["partial_tokens"],
           "rounds": migrate["chaos"]["rounds"],
           "shipped_blocks": migrate["migration"]["shipped_blocks"],
           "installed_blocks": migrate["migration"]["installed_blocks"],
           "prefix_hit_tokens": migrate["dest"]["prefix_hit_tokens"]}
    if not migrate["ok"] or got != expected["migrate"]:
        raise AssertionError(f"operator_scripts migrate: {migrate}, "
                             f"{got} != {expected['migrate']}")

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS
    cut = f"1b_{expected['disagg_layers']}_layers"
    LLAMA_PRESETS[cut] = dataclasses.replace(
        LLAMA_PRESETS["1b"], num_layers=expected["disagg_layers"])
    zero_attention_counts()
    start = time.perf_counter()
    try:
        disagg = disagg_smoke.run(preset=cut,
                                  window=expected["disagg_window"])
    finally:
        del LLAMA_PRESETS[cut]
    disagg_s = time.perf_counter() - start
    disagg_launches = sum(attention_counts().values())
    torch.cuda.empty_cache()
    got = {"transfers": disagg["per_transfer"]["count"],
           "handle_hit_rate": disagg["per_transfer"]["handle_hit_rate"],
           "paged_launches": disagg_launches}
    if not disagg_smoke.passed(disagg) or got != expected["disagg"]:
        raise AssertionError(f"operator_scripts disagg_smoke: {disagg}, "
                             f"{got} != {expected['disagg']}")
    emit({"phase": "operator_scripts",
          "soak": {**soak, "attention_launches": soak_launches,
                   "drive_s": soak_s},
          "migrate": {**migrate, "paged_launches": migrate_launches,
                      "drive_s": migrate_s},
          "disagg_smoke": {**disagg, "paged_launches": disagg_launches,
                           "drive_s": disagg_s}})
    return soak_launches + migrate_launches + disagg_launches


# golden: the tone language's served texts, the TTS words' tones (Hz)
# and the limits of tests/test_tts.py's tone gate
GOLDEN = {"texts": {"s0": ["charlie", "alpha"], "s1": ["bravo"]},
          "tones": {"alpha": 330.0, "bravo": 550.0, "charlie": 770.0},
          "tone_hz": 60.0, "samples": (2400, 8000), "gl_iters": 24}
# examples: each runner's --self-test line, as the JAX script prints it
EXAMPLE_LINES = {
    "aloha_honua": ["Aloha Pele!", "self-test ok: 1 greeting(s)"],
    "xgo_robot": ["self-test ok: pose.x=25.0 claw=128 3 video frames "
                  "(120, 160, 3)"],
    "robot_control": ["self-test ok: drove robot to pose.x=10.0, claw=255, "
                      "3 frames, ascii 20 rows"],
}


def golden_recipes():
    """tests/torch_golden.py, from the tests folder beside this script."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_golden
    return torch_golden


def golden_serve(golden, device, weights: str, wavs: dict, streams,
                 **parameters) -> dict:
    """Each stream's wav through the golden ASR pipeline on `device`
    (PE_LogMel on the same device): {stream: (text, tokens)}."""
    import numpy as np

    from aiko_services_tpu_torch.pipeline import (Pipeline,
                                                  parse_pipeline_definition)

    frontend = parameters.pop("frontend", "mel")
    definition = golden.asr_definition(weights, frontend, **parameters)
    definition["parameters"]["PE_LogMel.device"] = \
        "cpu" if str(device) == "cpu" else "default"
    runtime, compute = host_runtime(device)
    pipeline = Pipeline(runtime, parse_pipeline_definition(definition),
                        stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    for sid in streams:
        pipeline.create_stream(sid, lease_time=0, parameters={
            "PE_AudioReadFile.pathname": wavs[sid]})
        pipeline.post("process_frame", sid, {})
    engine = runtime.event
    for _ in range(400):
        if len(done) == len(streams):
            break
        engine.clock.advance(0.01)
        engine.step()
    if len(done) != len(streams) or pipeline.recovery_stats["frames_failed"]:
        raise AssertionError(f"golden {frontend} {parameters}: "
                             f"{len(done)} of {len(streams)} frames, "
                             f"{pipeline.recovery_stats}")
    served = {f.stream_id: (f.swag["text"],
                            np.asarray(f.swag["tokens"]).tolist())
              for f in done}
    stop_pipeline(runtime, compute, pipeline)
    return served


def golden_margin(golden, params, device, words) -> float:
    """The trained f32 model's smallest top-2 logit gap along its own
    greedy tokens for the utterance, teacher-forced on the host-mel
    input (zero-padded to the bucket, as the element collates)."""
    import numpy as np

    from aiko_services_tpu_torch.models.whisper import (
        forward, greedy_decode_scored)

    config = golden.whisper_config()
    mel = golden.log_mel(golden.utterance(words), device)
    buffer = np.zeros((golden.BUCKET, config.n_mels), np.float32)
    buffer[:min(mel.shape[0], golden.BUCKET)] = mel[:golden.BUCKET]
    mel = torch.from_numpy(buffer[None]).to(device)
    tokens, lengths, _ = greedy_decode_scored(params, config, mel,
                                              max_tokens=golden.MAX_TOKENS)
    emitted = tokens[0, :int(lengths[0]) + 1].long()    # through the eot
    prefix = torch.cat([torch.tensor([config.sot], device=device),
                        emitted[:-1]])[None]
    with torch.no_grad():
        logits = forward(params, config, mel, prefix)[0].float()
    top = torch.topk(logits, 2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min())


def phase_golden(device=None) -> int:
    """The golden trained speech models on the card (35k).  Returns the
    attention launches of the phase's drives."""
    import numpy as np

    from aiko_services_tpu_torch import resolve_device
    from aiko_services_tpu_torch.bridge import save_flat_npz
    from aiko_services_tpu_torch.elements.speech import save_wav
    from aiko_services_tpu_torch.pipeline import (Pipeline,
                                                  parse_pipeline_definition)

    device = resolve_device(device)
    golden = golden_recipes()
    zero_attention_counts()
    start = time.perf_counter()
    asr_stats, tts_stats = {}, {}
    asr = golden.train_whisper(device, stats=asr_stats)
    tts = golden.train_tts(device=device, stats=tts_stats)
    margins = {sid: golden_margin(golden, asr, device, words)
               for sid, words in GOLDEN["texts"].items()}
    want = {sid: " ".join(words) for sid, words in GOLDEN["texts"].items()}
    with tempfile.TemporaryDirectory() as directory:
        weights = os.path.join(directory, "asr.npz")
        save_flat_npz(asr, weights)
        tts_weights = os.path.join(directory, "tts.npz")
        save_flat_npz(tts, tts_weights)
        wavs = {}
        for sid, words in GOLDEN["texts"].items():
            wavs[sid] = os.path.join(directory, f"{sid}.wav")
            save_wav(wavs[sid], golden.utterance(words))
        served = {
            "host_mel": golden_serve(golden, device, weights, wavs,
                                     ("s0", "s1")),
            "mulaw": golden_serve(golden, device, weights, wavs, ("s0",),
                                  frontend="mulaw"),
            "kv_quant": golden_serve(golden, device, weights, wavs,
                                     ("s0",), kv_quant=True)}
        wrong = {path: {sid: text for sid, (text, _) in texts.items()
                        if (text if path == "host_mel" else text.strip())
                        != want[sid]}
                 for path, texts in served.items()}

        runtime, compute = host_runtime(device)
        pipeline = Pipeline(runtime, parse_pipeline_definition(
            golden.tts_definition(tts_weights, GOLDEN["gl_iters"])),
            stream_lease_time=0)
        pipeline.create_stream("t0", lease_time=0)
        tones = {}
        for word, freq in GOLDEN["tones"].items():
            ok, swag = pipeline.process_frame("t0", {"text": word})
            audio = np.asarray(swag["audio"]) if ok else np.zeros(0)
            measured = golden.dominant_frequency(audio) if audio.size \
                else 0.0
            tones[word] = {"samples": int(audio.size), "hz": measured,
                           "ok": bool(ok) and
                           abs(measured - freq) < GOLDEN["tone_hz"] and
                           GOLDEN["samples"][0] <= audio.size <=
                           GOLDEN["samples"][1]}
        stop_pipeline(runtime, compute, pipeline)
    launches = sum(attention_counts().values())
    emit({"phase": "golden", "device": str(device),
          "whisper_train": {**asr_stats, "s_per_step":
                            asr_stats["seconds"] / asr_stats["steps"]},
          "tts_train": {**tts_stats, "s_per_step":
                        tts_stats["seconds"] / tts_stats["steps"]},
          "served": served, "wrong": wrong, "f32_top2_gap_min": margins,
          "tones": tones, "attention_launches": launches,
          "seconds": time.perf_counter() - start})
    failed = {path: texts for path, texts in wrong.items() if texts}
    if failed or not all(t["ok"] for t in tones.values()) or launches:
        raise AssertionError(f"golden: texts {failed}, tones {tones}, "
                             f"{launches} attention launches")
    return launches


def phase_examples() -> int:
    """The examples' runners' self-tests through main() (35l).  Returns
    the attention launches of the drives."""
    import io
    from contextlib import redirect_stdout

    from aiko_services_tpu_torch.examples.aloha_honua import aloha_honua
    from aiko_services_tpu_torch.examples.xgo_robot import (robot_control,
                                                            xgo_robot)

    zero_attention_counts()
    lines, seconds = {}, {}
    for name, module in (("aloha_honua", aloha_honua),
                         ("xgo_robot", xgo_robot),
                         ("robot_control", robot_control)):
        out = io.StringIO()
        start = time.perf_counter()
        with redirect_stdout(out):
            module.main(["--self-test"])
        seconds[name] = time.perf_counter() - start
        lines[name] = out.getvalue().splitlines()
    launches = sum(attention_counts().values())
    emit({"phase": "examples", "lines": lines, "seconds": seconds,
          "attention_launches": launches})
    if lines != EXAMPLE_LINES or launches:
        raise AssertionError(f"examples: {lines} != {EXAMPLE_LINES}, "
                             f"{launches} attention launches")
    return launches


def phase_grad_guard() -> dict:
    """Each kernel wrapper raises on a CUDA operand that requires grad
    (the kernels have no backward), and launches nothing doing so."""
    from aiko_services_tpu_torch.ops import attention as A
    from aiko_services_tpu_torch.ops import paged_attention as PA

    generator = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    q, k, v = (randn(1, 2, 1024, 64) for _ in range(3))
    qd = randn(1, 2, 1, 64)
    paged = list(paged_case(generator, 256, 8))
    calls = {
        "flash_attention": lambda grad: A.flash_attention(
            grad(q), k, v),
        "cross_decode_attention": lambda grad: A.cross_decode_attention(
            qd, grad(k), v),
        "paged_decode_attention": lambda grad: PA.paged_decode_attention(
            grad(paged[0]), *paged[1:], groups=4),
    }
    zero_attention_counts()
    refused = {}
    for name, call in calls.items():
        try:
            call(lambda t: t.clone().requires_grad_(True))
        except RuntimeError as error:
            refused[name] = "no backward" in str(error)
    counts = attention_counts()
    if refused != {name: True for name in calls} or any(counts.values()):
        raise AssertionError(f"grad guard: refused {refused}, launches "
                             f"{counts}")
    emit({"phase": "grad_guard", "refused": sorted(refused)})
    return refused


# the ops phase: 8 requests of 64 prompt tokens and 160 new tokens
# through the llama phase's decoder (16 steps a round: ~10 decode rounds),
# one virtual second a quarter per round; the publisher, the health
# aggregator and the autoscaler tick every half virtual second
OPS_REQUESTS = {"count": 8, "prompt": 64, "new": 160, "seed": 17}
OPS_ROUND_S = 0.25                  # virtual seconds a pump round
OPS_TAIL_S = 8.0                    # virtual seconds after the last round
OPS_TRACE_AFTER = 3                 # rounds before the window is armed
OPS_TRACE_S = 0.15                  # the window's wall seconds
OPS_POLICY = {"min_clients": 1, "max_clients": 2, "ttft_p95_up": 1e-4,
              "ttft_p95_down": 1e-4, "mailbox_depth_up": math.inf,
              "hop_p95_up": math.inf, "batch_wait_up": math.inf,
              "queue_depth_up": math.inf, "window": 2.0, "hysteresis": 2,
              "cooldown": 2.0}
# the trace's event categories that are kernels run on the card
TRACE_KERNEL_CATEGORIES = ("kernel",)
# what the CPU rehearsal of the drive gives: the decode steps, and the
# autoscaler's (virtual second, action, reason) and the SLO rule's alert
# states in order (they depend on virtual time and the request stream,
# not on the card's speed: any TTFT is above OPS_POLICY's 1e-4 s)
OPS_DECODE_STEPS = 160
OPS_DECISIONS = [(1.0, "hold", "at-min"), (2.0, "up", "overload")] + \
    [(t, "hold", "cooldown") for t in (2.55, 3.05, 3.55)] + \
    [(4.05, "down", "underload")] + \
    [(t, "hold", "cooldown") for t in (4.55, 5.05, 5.55, 6.05)] + \
    [(t, "hold", "at-min") for t in (6.55, 7.05, 7.55, 8.05, 8.55, 9.05,
                                     9.5, 10.0, 10.5, 11.0)]
OPS_ALERTS = [(1.5, "firing"), (3.05, "resolved")]


def trace_kernel_launches(path: str, names) -> int:
    """Kernel events in a torch.profiler Chrome trace whose name holds
    one of `names`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for event in events
               if event.get("cat") in TRACE_KERNEL_CATEGORIES and
               any(name in event.get("name", "") for name in names))


def phase_ops() -> int:
    """The operations plane around Llama-1B's paged decoder (35b in the
    docstring); returns the paged kernel's launches in the drive."""
    import numpy as np

    from aiko_services_tpu_torch.autoscaler import Autoscaler, ScalePolicy
    from aiko_services_tpu_torch.event import (EventEngine, VirtualClock,
                                               settle_virtual)
    from aiko_services_tpu_torch.lifecycle import (LifeCycleClient,
                                                   LifeCycleManager)
    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.observe import profiler as OP
    from aiko_services_tpu_torch.observe.export import MetricsPublisher
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.observe.series import (HealthAggregator,
                                                        SLORule)
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.placement import DevicePool
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    engine, broker = EventEngine(VirtualClock()), MemoryBroker()

    def runtime(name):
        return ProcessRuntime(
            name=name, engine=engine, namespace="ops", process_id=name,
            transport_factory=lambda on_message, lwt_topic, lwt_payload,
            lwt_retain: MemoryMessage(
                on_message=on_message, broker=broker, lwt_topic=lwt_topic,
                lwt_payload=lwt_payload, lwt_retain=lwt_retain)
        ).initialize()

    start = time.perf_counter()
    config = llama_1b()
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    registry = MetricsRegistry()
    decoder = ContinuousDecoder(params, config, name="ops",
                                registry=registry, **LLAMA_DECODER)
    serve_rt, health_rt = runtime("ops_serve"), runtime("ops_health")
    publisher = MetricsPublisher(serve_rt, interval=0.5, registry=registry)
    rule = SLORule(name="ops-ttft", kind="level",
                   series="serving_ttft_seconds:p95",
                   threshold=OPS_POLICY["ttft_p95_up"], window=2.0)
    aggregator = HealthAggregator(health_rt, rules=[rule], interval=0.5,
                                  registry=MetricsRegistry())
    alerts = []
    # one phase's alert states, read after its drive
    # graft: disable=lint-unbounded-queue
    health_rt.add_message_handler(
        lambda _topic, payload: alerts.append(
            (round(engine.clock.now(), 6), json.loads(payload)["state"])),
        "ops/alert/ops-ttft")

    def spawner(client_id, manager_topic):
        client_rt = runtime(f"ops_client{client_id}")
        LifeCycleClient(client_rt, f"ops_client{client_id}", manager_topic,
                        client_id)
        return client_rt

    manager = LifeCycleManager(health_rt, "ops_fleet", spawner,
                               terminator=lambda _id, rt: rt.terminate())
    autoscaler = Autoscaler(health_rt, "ops_scale", manager=manager,
                            policy=ScalePolicy(**OPS_POLICY), interval=0.5)
    decisions = []
    count_decision = autoscaler._count_decision

    def decided(action, reason):
        decisions.append((round(engine.clock.now(), 6), action, reason))
        count_decision(action, reason)

    autoscaler._count_decision = decided
    manager.create_clients(1)
    settle_virtual(engine, 0.5)
    pool = DevicePool()
    held = pool.allocate(1, "ops_decoder")
    try:
        pool.allocate(1, "ops_second")
        second = "allocated"
    except RuntimeError as exc:
        second = f"refused: {exc}"
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start

    rng = np.random.default_rng(OPS_REQUESTS["seed"])
    done = {}
    for i in range(OPS_REQUESTS["count"]):
        decoder.submit(f"ops{i}", rng.integers(
            0, config.vocab, OPS_REQUESTS["prompt"]).tolist(),
            OPS_REQUESTS["new"], lambda rid, t: done.update({rid: list(t)}))
    profiler = decoder.profiler
    logdir = os.path.join(tempfile.mkdtemp(prefix="aiko_ops_"), "trace")
    zero_paged_counts()
    window = {"start": None, "stop": None}
    # committed rounds in and outside the trace window: their count, the
    # profiler's wall and (outside) the wall timed around pump
    inside = {"rounds": 0, "profiled_wall_s": 0.0}
    outside = {"rounds": 0, "pump_wall_s": 0.0, "profiled_wall_s": 0.0,
               "sync_debug": "error"}
    split = []                      # each committed round's phases, ms
    rounds = 0
    while not decoder.idle:
        if rounds == OPS_TRACE_AFTER:
            OP.arm_trace(logdir, OPS_TRACE_S)
        before = OP.trace_state()
        in_window = before["armed"] or before["active"]
        committed, wall = profiler.rounds, profiler.wall_s
        phase_s = dict(profiler.phase_s)
        if not in_window:
            torch.cuda.set_sync_debug_mode("error")
        try:
            round_start = time.perf_counter()
            decoder.pump()
            external = time.perf_counter() - round_start
        finally:
            torch.cuda.set_sync_debug_mode("default")
        after = OP.trace_state()
        launched = P.launches["paged_decode_attention"]
        if after["active"] and not before["active"]:
            window["start"] = launched
        if before["active"] and not after["active"]:
            window["stop"] = launched
        if profiler.rounds > committed:
            split.append({name: round(1e3 * (s - phase_s[name]), 3)
                          for name, s in profiler.phase_s.items()
                          if s > phase_s[name]})
            if in_window:
                inside["rounds"] += 1
                inside["profiled_wall_s"] += profiler.wall_s - wall
            else:
                outside["rounds"] += 1
                outside["pump_wall_s"] += external
                outside["profiled_wall_s"] += profiler.wall_s - wall
        rounds += 1
        settle_virtual(engine, OPS_ROUND_S)
        if rounds > 200:
            raise AssertionError("the ops decoder did not drain")
    torch.cuda.synchronize()
    launches = P.launches["paged_decode_attention"]
    stats = decoder.phase_stats()
    steps = decoder.stats["steps"]
    settle_virtual(engine, OPS_TAIL_S)
    state = OP.trace_state()
    for part in (autoscaler, aggregator, publisher, manager):
        part.stop()
    released = pool.release("ops_decoder")
    again = pool.allocate(1, "ops_after")
    pool.release("ops_after")

    if sorted(done) != [f"ops{i}" for i in range(OPS_REQUESTS["count"])] \
            or any(len(t) != OPS_REQUESTS["new"] for t in done.values()):
        raise AssertionError(f"{len(done)} requests completed")
    if decoder.pool.used_blocks() != 0:
        raise AssertionError("pool blocks still owned after the ops drive")
    if launches != config.num_layers * steps:
        raise AssertionError(f"paged launches {launches} != "
                             f"{config.num_layers} x {steps} steps")
    if OPS_DECODE_STEPS is not None and steps != OPS_DECODE_STEPS:
        raise AssertionError(f"{steps} decode steps, not {OPS_DECODE_STEPS}")
    phase_sum = sum(entry["s"] for entry in stats["phases"].values())
    if abs(phase_sum - stats["wall_s"]) > 0.01 * stats["wall_s"]:
        raise AssertionError(f"phases sum to {phase_sum} s of a "
                             f"{stats['wall_s']} s wall")
    if not outside["rounds"] or abs(outside["profiled_wall_s"] -
                                    outside["pump_wall_s"]) > \
            0.01 * outside["pump_wall_s"]:
        raise AssertionError(f"the profiler's wall against the wall timed "
                             f"around pump: {outside}")
    if stats["attributed_frac"] < 0.9:
        raise AssertionError(f"attributed fraction "
                             f"{stats['attributed_frac']}")
    if state["error"] is not None or state["captures"] != 1 or \
            window["start"] is None or window["stop"] is None:
        raise AssertionError(f"the trace window did not open and close: "
                             f"{state} {window}")
    window_launches = window["stop"] - window["start"]
    traced = trace_kernel_launches(
        state["path"], ("paged_split_kernel", "paged_mma_kernel"))
    trace_bytes = os.path.getsize(state["path"])
    shutil.rmtree(os.path.dirname(logdir))
    if traced != window_launches or not window_launches:
        raise AssertionError(f"the trace holds {traced} paged launches, "
                             f"the wrapper counted {window_launches}")
    if OPS_DECISIONS is not None and decisions != OPS_DECISIONS:
        raise AssertionError(f"autoscaler decisions {decisions} != "
                             f"{OPS_DECISIONS}")
    if OPS_ALERTS is not None and alerts != OPS_ALERTS:
        raise AssertionError(f"alert states {alerts} != {OPS_ALERTS}")
    if not second.startswith("refused") or not released or \
            again.device_ids != held.device_ids:
        raise AssertionError(f"the one-card pool: second allocation "
                             f"{second}, released {released}")
    host_sync = stats["phases"].get("host_sync", {})
    emit({"phase": "ops", "setup_s": setup_s, "rounds": rounds,
          "committed_rounds": stats["rounds"], "steps": steps,
          "paged_launches": launches, "phase_stats": stats,
          "attributed_fraction": profiler.attributed_fraction(),
          "host_sync_gb_per_s": host_sync.get("gb_per_s"),
          "host_sync_share_of_peak_bytes":
              host_sync.get("gb_per_s", 0.0) * 1e9 / PEAK_BYTES_PER_S,
          "round_phase_ms": split, "outside_window": outside,
          "trace_window": {**inside, "wrapper_launches": window_launches,
                           "trace_launches": traced,
                           "trace_bytes": trace_bytes},
          "decisions": decisions, "clients": len(manager.clients),
          "alerts": alerts, "fired": dict(aggregator.fired),
          "pool": {"devices": [str(d) for d in pool.devices],
                   "first": held.describe(), "second": second,
                   "released": released, "again": again.describe()}})
    return launches


# -- Llama-3-8B on a one-rank mesh, the agent on a mesh -----------------------

def llama_8b(**changes):
    """The port's 8b preset (Llama-3-8B: 4096 / 32 heads / 8 KV heads,
    head dim 128 / 32 layers / 14,336 ffn / 128,256 vocab) with
    `changes`, its widths checked."""
    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS
    config = dataclasses.replace(LLAMA_PRESETS["8b"], max_seq_len=1024,
                                 **changes)
    if (config.dim, config.num_heads, config.num_kv_heads, config.ffn_dim,
            config.vocab, config.head_dim) != \
            (4096, 32, 8, 14336, 128256, 128):
        raise AssertionError(f"not the 8b preset's widths: {config}")
    return config


def phase_llama_8b() -> int:
    """Llama-3-8B at full width and depth in bf16, seeded weights made on
    the card, placed by ComputeRuntime.place_params with llama_axes on a
    one-rank model mesh and served by the paged ContinuousDecoder on
    that mesh (LLAMA_8B_DECODER): LLAMA_8B_REQUESTS; every request
    completes with its budget, the pool drains, the paged kernel
    launches 32 x LLAMA_8B_DECODE_STEPS at head dim 128; tokens/s, round
    s, the weights' and the pool's bytes, the per-rank plan of TP 8
    (llama_rank_budget), one steady round under torch.profiler.  Returns
    the paged launches."""
    import numpy as np

    from aiko_services_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                      llama_axes,
                                                      llama_init,
                                                      llama_rank_budget)
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = llama_8b(dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime, compute = host_runtime(mesh=create_mesh({"model": 1}))
    start = time.perf_counter()
    params = compute.place_params(
        llama_init(torch.Generator(device="cuda").manual_seed(0), config),
        llama_axes(config))
    decoder = ContinuousDecoder(params, config, mesh=compute.sharding_mesh,
                                **LLAMA_8B_DECODER)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    weight_bytes = sum(leaf.numel() * leaf.element_size()
                       for leaf in params.parameters())

    spec = LLAMA_8B_REQUESTS
    rng = np.random.default_rng(spec["seed"])
    requests = [(f"q{i}", rng.integers(0, config.vocab,
                                       spec["prompt"]).tolist(), spec["new"])
                for i in range(spec["count"])]
    done = {}

    def keep(request_id, tokens):
        done[request_id] = list(tokens)

    # the main path's run: counts set to 0 just before, read just after
    for name in P.launches:
        P.launches[name] = 0
    start = time.perf_counter()
    for rid, prompt, new in requests:
        decoder.submit(rid, prompt, new, keep)
    round_s = []
    while not decoder.idle:
        round_start = time.perf_counter()
        decoder.pump()
        round_s.append(time.perf_counter() - round_start)
        if len(round_s) > 100:
            raise AssertionError("the 8B decoder did not drain in 100 "
                                 "rounds")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(P.launches)
    stats = dict(decoder.stats)
    if sorted(done) != sorted(rid for rid, *_ in requests) or any(
            len(tokens) != spec["new"] or
            not all(0 <= t < config.vocab for t in tokens)
            for tokens in done.values()):
        raise AssertionError(f"8B requests: {len(done)} of {len(requests)} "
                             f"completed with their budgets")
    if decoder.pool.used_blocks() != 0:
        raise AssertionError(f"{decoder.pool.used_blocks()} pool blocks "
                             f"still owned after the run")
    expected = config.num_layers * LLAMA_8B_DECODE_STEPS
    if stats["steps"] != LLAMA_8B_DECODE_STEPS or \
            launches["paged_decode_attention"] != expected or \
            sum(launches.values()) != expected:
        raise AssertionError(
            f"8B paged launches {launches} over {stats['steps']} decode "
            f"steps; predicted {expected} over {LLAMA_8B_DECODE_STEPS}")
    generated = sum(len(tokens) for tokens in done.values())
    pool_bytes = decoder.kv_cache_bytes()
    memory_gb = torch.cuda.max_memory_allocated() / 1e9

    # one steady decode round of 16 fresh requests under the profiler
    for i in range(16):
        decoder.submit(f"p{i}", rng.integers(0, config.vocab, 64).tolist(),
                       40, lambda *_: None)
    decoder.pump()                 # admits
    decoder.pump()                 # first decode round
    profile = profile_round(decoder, "llama_8b decode")
    while not decoder.idle:
        decoder.pump()
    # the plan on the meta device: no weight materialised
    plan = dataclasses.replace(LLAMA_PRESETS["8b"], dtype=torch.bfloat16,
                               max_seq_len=LLAMA_8B_PLAN["positions"])
    budget = llama_rank_budget(plan, {"model": LLAMA_8B_PLAN["tp"]},
                               LLAMA_8B_PLAN["slots"],
                               LLAMA_8B_PLAN["positions"])
    emit({"phase": "llama_8b", "requests": len(done), "tokens": generated,
          "setup_s": setup_s, "wall_s": wall,
          "tokens_per_s": generated / wall, "rounds": len(round_s),
          "first_round_s": round_s[0],
          "steady_round_s": statistics.median(round_s[1:]),
          "round_s": round_s, "steps": stats["steps"],
          "paged_launches": launches["paged_decode_attention"],
          "paged_launches_expected": expected,
          "mesh": compute.ec_producer.get("mesh"),
          "weight_gb": weight_bytes / 1e9, "kv_cache_gb": pool_bytes / 1e9,
          "pool_blocks": decoder.pool.num_blocks - 1,
          "max_memory_gb": memory_gb,
          "tp8_plan_gb_per_rank": {key: value / 1e9
                                   for key, value in budget.items()},
          "sample_tokens": done["q0"][:6]})
    emit({"phase": "profile", **profile})
    compute.stop()
    runtime.terminate()
    del params, decoder
    torch.cuda.empty_cache()
    return launches["paged_decode_attention"]


def phase_llama_8b_f32() -> dict:
    """Llama-3-8B's widths at 2 layers in f32 on the one-rank model mesh:
    the paged decoder's tokens (the kernel's f32 split path at head dim
    128) against llama_greedy_decode's plain path, a top-2 gap under
    1e-4 a tie."""
    import numpy as np

    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = llama_8b(num_layers=2, dtype=torch.float32)
    params = llama_init(torch.Generator(device="cuda").manual_seed(1),
                        config)
    decoder = ContinuousDecoder(params, config,
                                mesh=create_mesh({"model": 1}),
                                **{**LLAMA_8B_DECODER, "max_slots": 4})
    rng = np.random.default_rng(3)
    prompts = {f"f{n}": rng.integers(0, config.vocab, n).tolist()
               for n in (20, 41, 64)}
    record = {"phase": "llama_8b_f32",
              **paged_against_greedy(params, config, decoder, prompts, 24)}
    emit(record)
    del params, decoder
    torch.cuda.empty_cache()
    return record


def phase_agent_mesh(reference: dict) -> dict:
    """The agent phase's pipeline, parameters and conversation on a
    ComputeRuntime built over create_mesh({"model": 1}): PE_LlamaAgent
    places Llama-1B with llama_axes and serves through its decoder on
    the mesh.  Every (stream, turn)'s tokens, the prefill and hit tokens,
    the prefix admits, the decode steps and the paged launches equal the
    agent phase's (the same seed, the same card).  Returns the paged
    launches by path."""
    import numpy as np

    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.parallel import create_mesh

    with agent_preset(dtype=torch.bfloat16) as config:
        check_1b(config)
        runtime, compute = host_runtime(mesh=create_mesh({"model": 1}))
        texts = agent_texts(np.random.default_rng(AGENT_SEED))
        extends = []

        def before_drive(agent):
            extends.append(count_extend_launches(agent.decoder))
            for name in P.launches:
                P.launches[name] = 0

        pipeline, agent, frames, virtual_s, wall_s = conversation(
            runtime, texts, before_drive)
        torch.cuda.synchronize()
        launches = dict(P.launches)
    decoder, cache = agent.decoder, agent.prefix_cache
    outcome = agent_outcome(frames, dict(decoder.stats), dict(cache.stats))
    extend_dispatches, extend_launches = extends[0]
    measured = {"decode": launches["paged_decode_attention"] -
                extend_launches, "extend": extend_launches}
    failed = pipeline.recovery_stats["frames_failed"]
    if decoder.mesh is not compute.sharding_mesh or \
            compute.ec_producer.get("mesh") != {"model": 1}:
        raise AssertionError("the agent's decoder is not on the runtime's "
                             "mesh")
    if failed or outcome != reference:
        differing = sorted(key for key in reference
                           if outcome.get(key) != reference[key])
        raise AssertionError(f"agent on the mesh differs from the agent "
                             f"phase in {differing} ({failed} frames "
                             f"failed)")
    expected = {"decode": config.num_layers * AGENT_DECODE_STEPS,
                "extend": config.num_layers * AGENT_EXTEND_DISPATCHES}
    if measured != expected or extend_dispatches != AGENT_EXTEND_DISPATCHES:
        raise AssertionError(f"agent_mesh paged launches {measured} != "
                             f"{expected}")
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    cache.purge()
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    emit({"phase": "agent_mesh", "mesh": {"model": 1},
          "frames": len(frames), "frames_failed": failed,
          "tokens_equal_agent": True,
          "hit_tokens": outcome["hit_tokens"],
          "tokens_prefill": outcome["tokens_prefill"],
          "prefix_admits": outcome["prefix_admits"],
          "decode_steps": outcome["decode_steps"],
          "paged_launches": measured, "virtual_s": virtual_s,
          "wall_s": wall_s})
    return measured


# the agent's batched mode, its default (phase agent_mesh_modes): the
# agent phase's streams and turns through PE_LlamaAgent at the 1b preset,
# each batch up to AGENT_STREAMS prompts padded to prompt_length and
# answered by llama_greedy_decode (no paged kernel); AGENT_BATCHED_F32
# layers for the f32 token check
AGENT_BATCHED = {"preset": "1b", "mode": "batched",
                 "max_batch": AGENT_STREAMS,
                 "max_tokens": AGENT_PARAMETERS["max_tokens"],
                 "prompt_length": AGENT_PARAMETERS["prompt_length"],
                 "max_wait": 0.01}
AGENT_BATCHED_F32 = 2


def batched_run(texts: dict, mesh=None, **changes) -> dict:
    """The agent's conversation in batched mode on a ComputeRuntime over
    `mesh` (None: none), the 1b preset with `changes`: each (stream,
    turn)'s tokens, the batch former's counts, whether its cut was
    agreed, and the paged kernel's launches (none)."""
    from aiko_services_tpu_torch.ops import paged_attention as P

    for name in P.launches:
        P.launches[name] = 0
    with agent_preset(**changes) as config:
        if "num_layers" not in changes:
            check_1b(config)
        runtime, compute = host_runtime(mesh=mesh)
        pipeline, agent, frames, virtual_s, wall_s = conversation(
            runtime, texts, parameters=AGENT_BATCHED)
        scheduler = compute.programs[agent._program].scheduler
        stats = dict(scheduler.stats)
        failed = pipeline.recovery_stats["frames_failed"]
        for stream_id in list(pipeline.streams):
            pipeline.destroy_stream(stream_id)
        pipeline.stop()
        compute.stop()
        runtime.terminate()
    if len(frames) != AGENT_STREAMS * AGENT_TURNS or failed:
        raise AssertionError(f"batched agent: {len(frames)} frames, "
                             f"{failed} failed")
    return {"tokens": {f"{stream}/{turn}": [int(t) for t in
                                            frame.swag["response_tokens"]]
                       for (stream, turn), frame in frames.items()},
            "counts": {key: stats[key] for key in (
                "batches", "items", "full_batches", "deadline_dispatches")},
            "agreed": scheduler.agreed,
            "paged_launches": sum(P.launches.values()),
            "virtual_s": virtual_s, "wall_s": wall_s}


def phase_agent_mesh_modes(disagg_tokens: dict) -> dict:
    """The agent's batched mode and its disagg on a ComputeRuntime over
    create_mesh({"model": 1}), the agreed paths of a mesh at one rank
    (the cut and the landings decided at rank 0, with no gather):
    batched at Llama-1B's full width in bf16, against the same agent
    without a mesh (its batches, items and tokens), and in f32 at
    AGENT_BATCHED_F32 layers (tokens); then agent_disagg's drive with
    the agent over the mesh, under torch's sync debug mode: its counts
    AGENT_DISAGG_COUNTS, no request lost, no local fallback, no
    synchronizing call, every installed block byte-equal to its shipped
    rows, and every turn's tokens agent_disagg's.  Returns the paged
    launches by (variant, path)."""
    import numpy as np

    from aiko_services_tpu_torch.parallel import create_mesh

    texts = agent_texts(np.random.default_rng(AGENT_SEED))
    runs = {}
    for label, changes in (("bf16", {"dtype": torch.bfloat16}),
                           ("f32", {"dtype": torch.float32,
                                    "num_layers": AGENT_BATCHED_F32})):
        plain = batched_run(texts, **changes)
        meshed = batched_run(texts, mesh=create_mesh({"model": 1}),
                             **changes)
        if not meshed["agreed"] or plain["agreed"] or \
                meshed["tokens"] != plain["tokens"] or \
                meshed["counts"] != plain["counts"] or \
                meshed["paged_launches"] or plain["paged_launches"]:
            raise AssertionError(
                f"batched agent on the mesh ({label}): counts "
                f"{meshed['counts']} against {plain['counts']}, tokens "
                f"equal {meshed['tokens'] == plain['tokens']}, agreed "
                f"{meshed['agreed']}, paged launches "
                f"{meshed['paged_launches']}")
        runs[label] = {"counts": meshed["counts"],
                       "tokens_equal_unsharded": True,
                       "wall_s": meshed["wall_s"],
                       "wall_s_unsharded": plain["wall_s"]}
    # the counts are set to 0 just before the disaggregated drive
    # (agent_disagg_run's before_drive) and read just after
    disagg = agent_disagg_run(mesh=create_mesh({"model": 1}),
                              watch_syncs=True)
    record = disagg["record"]
    if disagg["tokens"] != disagg_tokens or \
            record["client"]["local_fallbacks"] or \
            record["stream_syncs"]:
        raise AssertionError(
            f"agent_disagg on the mesh: tokens equal "
            f"{disagg['tokens'] == disagg_tokens}, client "
            f"{record['client']}, {record['stream_syncs']} syncs")
    emit({"phase": "agent_mesh_modes", "mesh": {"model": 1},
          "batched": runs,
          "disagg": {**record, "tokens_equal_agent_disagg": True,
                     "requests_lost": 0}})
    return disagg["counts"]


@contextlib.contextmanager
def agent_8b_preset(**changes):
    """The port's "8b" preset as llama_8b gives it (max_seq 1024) with
    `changes`, for the element to read at its setup; restored after."""
    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS
    base = LLAMA_PRESETS["8b"]
    LLAMA_PRESETS["8b"] = llama_8b(**changes)
    try:
        yield LLAMA_PRESETS["8b"]
    finally:
        LLAMA_PRESETS["8b"] = base


def agent_8b_parameters(config) -> dict:
    return {**tiered_parameters(config), **AGENT_8B_OVERRIDES,
            "host_kv_mb": AGENT_8B_HOST_MB}


def drain_fourth_turn(engine, pipeline, agent, texts) -> dict:
    """A fourth turn on every stream, drained with a zero deadline after
    AGENT_8B_DRAIN_ROUNDS rounds: the live slots checkpoint into the
    cache, the queue evacuates, and after resume every descriptor is
    resubmitted (prompt + generated) so each frame completes.  Returns
    the counts."""
    decoder = agent.decoder
    done = []
    pipeline.add_frame_handler(done.append)
    for stream_id in texts:
        pipeline.post("process_frame", stream_id, {"text": "and then?"})
    while engine.step():
        pass
    rounds = decoder.stats["rounds"] + AGENT_8B_DRAIN_ROUNDS
    while decoder.stats["rounds"] < rounds:
        engine.clock.advance(0.002)
        engine.step()
    checkpointed = []
    evacuated = decoder.drain(deadline=0.0, on_evacuate=checkpointed.append)
    for _ in range(1000):
        if decoder.drained:
            break
        engine.clock.advance(0.002)
        engine.step()
    if not decoder.drained:
        raise AssertionError("the agent's drain did not complete")
    counts = {"evacuated": decoder.stats["drain_evacuated"],
              "checkpoints": decoder.stats["drain_checkpoints"],
              "queued_evacuated": len(evacuated),
              "live_checkpointed": len(checkpointed)}
    decoder.resume()
    for entry in evacuated + checkpointed:
        left = entry["max_new_tokens"] - len(entry["generated"])
        if left <= 0:
            entry["callback"](entry["request_id"], entry["generated"])
            continue
        decoder.submit(f"{entry['request_id']}.resumed",
                       entry["prompt"] + entry["generated"], left,
                       entry["callback"], tenant=entry["tenant"])
    for _ in range(20000):
        if len(done) >= len(texts):
            break
        engine.clock.advance(0.002)
        engine.step()
    counts["resumed_frames"] = len(done)
    if len(done) != len(texts):
        raise AssertionError(f"{len(done)} of {len(texts)} drained turns "
                             f"completed after resume")
    return counts


def phase_agent_8b() -> dict:
    """PE_LlamaAgent serving Llama-3-8B at full width and depth in bf16 on
    a ComputeRuntime over create_mesh({"model": 1}), with sessions and
    the host KV tier, under torch's sync debug mode, the KV ledger
    audited after every round, an AdmissionGate watching the decoder;
    the timed decisions (a passed deadline's shed, the drain and its
    checkpoint) ride the decoder's round note.  Returns the paged
    kernel's launches by path."""
    import numpy as np

    from aiko_services_tpu_torch.event import settle_virtual
    from aiko_services_tpu_torch.observe.ledger import assert_ledger_clean
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.ops.admission import AdmissionGate
    from aiko_services_tpu_torch.parallel import create_mesh

    with agent_8b_preset(dtype=torch.bfloat16) as config:
        parameters = agent_8b_parameters(config)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runtime, compute = host_runtime(mesh=create_mesh({"model": 1}))
        engine = runtime.event
        texts = agent_texts(np.random.default_rng(AGENT_SEED))
        extends, submitted, agents, refused = [], {}, [], {}
        audit = TierAudit()
        gate = AdmissionGate()
        demote = demote_between_turns(agents)
        verdicts = []

        def before_drive(agent):
            agents.append(agent)
            extends.append(count_extend_launches(agent.decoder))
            audit.bind(agent.decoder)
            gate.watch_decoder(agent.decoder)
            submit = agent.decoder.submit

            def recording(request_id, prompt, *args, **kwargs):
                submitted[request_id] = list(prompt)
                return submit(request_id, prompt, *args, **kwargs)
            agent.decoder.submit = recording
            # the main path's run: counts set to 0 just before
            for name in P.launches:
                P.launches[name] = 0
            torch.cuda.set_sync_debug_mode("warn")

        def between_turns(turn):
            demote(turn)
            if turn == 1:
                # a request whose deadline has passed: the gate does not
                # shed it (the decoder's note does), rank 0's verdict
                # refuses it at the next round
                verdicts.append(gate.shed_early(-1.0))
                agents[0].decoder.submit(
                    "late", [1] * 8, 4, lambda *_: None,
                    deadline=time.monotonic() - 1.0,
                    on_refused=lambda rid, why: refused.update(
                        {rid: why}))

        timer = RoundTimer()
        try:
            with sync_watch(arm=False) as syncs:
                pipeline, agent, frames, virtual_s, wall_s = conversation(
                    runtime, texts, before_drive, parameters,
                    between_turns, frame_deadline=1e9)
        finally:
            timer.close()
        torch.cuda.synchronize()
        launches = dict(P.launches)
        extend_dispatches, extend_launches = extends[0]
        rounds = list(timer.rounds)
        decoder, cache = agent.decoder, agent.prefix_cache
        stats, cache_stats = dict(decoder.stats), dict(cache.stats)
        store, promoter = cache.host_store, cache.promoter
        conversation_promoter = dict(promoter.stats)
        prompt_tokens = sum(len(p) for rid, p in submitted.items()
                            if rid != "late")
        drain = drain_fourth_turn(engine, pipeline, agent, texts)
        histories = {stream_id: list(agent._session_table.get(
            "default", stream_id)["history"]) for stream_id in texts}
        settle_virtual(engine, AGENT_PARAMETERS["session_lease"] + 1.0)
        for stream_id in list(pipeline.streams):
            pipeline.destroy_stream(stream_id)
        promoted_back = promote_and_purge(cache, histories)
        # what no session's history reaches (the drained turn's
        # checkpointed chains: its resumed request's history is prompt +
        # continuation) leaves the host tier by eviction
        host_left = len(store)
        store.max_bytes = 0
        store._evict_to_budget("")
        assert_ledger_clean(cache=cache, ledger=audit.ledger)
        audit.close()
        memory_gb = torch.cuda.max_memory_allocated() / 1e9
        promoter.stop()
        pipeline.stop()
        compute.stop()
        runtime.terminate()
    decode_launches = launches["paged_decode_attention"] - extend_launches
    if syncs:
        raise AssertionError(f"the 8B agent synchronized the stream "
                             f"beyond its one wait a round: {dict(syncs)}")
    failed = pipeline.recovery_stats["frames_failed"]
    if len(frames) != AGENT_STREAMS * AGENT_TURNS or failed:
        raise AssertionError(f"{len(frames)} agent frames, {failed} failed")
    for (stream_id, turn), frame in frames.items():
        tokens = frame.swag["response_tokens"]
        if len(tokens) != AGENT_PARAMETERS["max_tokens"] or not all(
                0 <= t < config.vocab for t in tokens):
            raise AssertionError(f"8B agent frame {stream_id} turn "
                                 f"{turn}: {len(tokens)} tokens")
    expected = {"decode": config.num_layers * AGENT_8B_DECODE_STEPS,
                "extend": config.num_layers * AGENT_8B_EXTEND_DISPATCHES}
    measured = {"decode": decode_launches, "extend": extend_launches}
    if measured != expected or stats["steps"] != AGENT_8B_DECODE_STEPS or \
            extend_dispatches != AGENT_8B_EXTEND_DISPATCHES or \
            sum(launches.values()) != launches["paged_decode_attention"]:
        raise AssertionError(
            f"8B agent paged launches {measured} != {expected} "
            f"({stats['steps']} decode steps, {extend_dispatches} extend "
            f"dispatches), all {launches}")
    if stats["tokens_prefill"] + cache_stats["hit_tokens"] != prompt_tokens:
        raise AssertionError(
            f"prefilled {stats['tokens_prefill']} + cached "
            f"{cache_stats['hit_tokens']} != {prompt_tokens} prompt tokens")
    if stats["prefix_admits"] < AGENT_MIN_PREFIX_ADMITS or \
            not cache_stats["demoted"] or not cache_stats["promoted"]:
        raise AssertionError(
            f"{stats['prefix_admits']} prefix admits, "
            f"{cache_stats['demoted']} demoted, {cache_stats['promoted']} "
            f"promoted")
    if refused != {"late": "shed"} or stats["admission_shed"] != 1 or \
            verdicts[0][0] or verdicts[0][1] is None:
        raise AssertionError(f"shed {refused}, {stats['admission_shed']} "
                             f"counted, the gate's verdict {verdicts}")
    if audit.failures:
        raise AssertionError(f"the KV ledger did not conserve: "
                             f"{audit.failures[:3]}")
    installs = {"async": conversation_promoter["installs_async"],
                "sync": conversation_promoter["installs_sync"]}
    if installs != AGENT_8B_INSTALLS:
        raise AssertionError(f"the conversation's host-tier installs "
                             f"{installs} != {AGENT_8B_INSTALLS}")
    if {key: drain[key] for key in AGENT_8B_DRAIN} != AGENT_8B_DRAIN:
        raise AssertionError(f"drain {drain} != {AGENT_8B_DRAIN}")
    generated = sum(len(f.swag["response_tokens"]) for f in frames.values())
    emit({"phase": "agent_8b", "mesh": {"model": 1},
          "streams": AGENT_STREAMS, "turns": AGENT_TURNS,
          "frames": len(frames), "frames_failed": failed,
          "tokens": generated, "wall_s": wall_s, "virtual_s": virtual_s,
          "tokens_per_s": generated / wall_s, "rounds": len(rounds),
          "first_round_s": rounds[0],
          "steady_round_s": statistics.median(rounds[2:]),
          "prompt_tokens": prompt_tokens,
          "tokens_prefill": stats["tokens_prefill"],
          "hit_tokens": cache_stats["hit_tokens"],
          "prefix_admits": stats["prefix_admits"],
          "demoted_blocks": cache_stats["demoted"],
          "promoted_blocks": cache_stats["promoted"],
          "cache_evictions": cache_stats["evictions"],
          "host_evicted": store.stats["evicted"],
          "promoter": dict(promoter.stats),
          "promoter_conversation": conversation_promoter,
          "shed": sorted(refused), "gate_wait_s": verdicts[0][1],
          "drain": drain, "promoted_back": promoted_back,
          "host_blocks_evicted_at_end": host_left,
          "pool_blocks_after_purge": decoder.pool.used_blocks(),
          "host_blocks_after_purge": len(store),
          "decode_steps": stats["steps"],
          "extend_dispatches": extend_dispatches,
          "paged_launches": measured, "paged_launches_expected": expected,
          "stream_syncs": sum(syncs.values()),
          "ledger_rounds_audited": audit.rounds,
          "max_memory_gb": memory_gb})
    del agent, decoder, cache
    torch.cuda.empty_cache()
    return measured


def phase_agent_8b_f32() -> dict:
    """agent_8b's conversation at the 8B widths and 2 layers in f32:
    every turn against llama_greedy_decode on its whole history prompt
    (a first mismatch at a top-2 logit gap under 1e-4 is a tie), with
    chains demoted and promoted between the turns."""
    import numpy as np

    from aiko_services_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with agent_8b_preset(num_layers=2, dtype=torch.float32) as config:
        runtime, compute = host_runtime(mesh=create_mesh({"model": 1}))
        prompts, agents = {}, []

        def before_drive(agent):
            agents.append(agent)
            submit = agent.decoder.submit

            def recording(request_id, prompt, *args, **kwargs):
                prompts[request_id] = list(prompt)
                return submit(request_id, prompt, *args, **kwargs)
            agent.decoder.submit = recording

        pipeline, agent, frames, virtual_s, wall_s = conversation(
            runtime, agent_texts(np.random.default_rng(AGENT_SEED)),
            before_drive, agent_8b_parameters(config),
            demote_between_turns(agents))
        ties, identical = [], 0
        for frame in frames.values():
            request_id = f"{frame.stream_id}.{frame.frame_id}"
            tie = greedy_check(agent.params, config, prompts[request_id],
                               list(frame.swag["response_tokens"]),
                               request_id)
            if tie is None:
                identical += 1
            else:
                ties.append(tie)
    cache = agent.prefix_cache
    if len(frames) != AGENT_STREAMS * AGENT_TURNS or \
            not cache.stats["demoted"] or not cache.stats["promoted"]:
        raise AssertionError(f"{len(frames)} frames, "
                             f"{cache.stats['demoted']} demoted, "
                             f"{cache.stats['promoted']} promoted")
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    cache.promoter.stop()
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    record = {"phase": "agent_8b_f32", "frames": len(frames),
              "identical": identical, "ties": ties,
              "demoted_blocks": cache.stats["demoted"],
              "promoted_blocks": cache.stats["promoted"],
              "hit_tokens": cache.stats["hit_tokens"],
              "prefix_admits": agent.decoder.stats["prefix_admits"],
              "virtual_s": virtual_s, "wall_s": wall_s}
    emit(record)
    del agent
    torch.cuda.empty_cache()
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from aiko_services_tpu_torch.ops import kernels

    smi = nvidia_smi()
    print(smi, flush=True)
    start = time.perf_counter()
    built = kernels.build()
    build_s = time.perf_counter() - start
    # per kernel instantiation (its mangled name): registers, shared
    # memory and spills as ptxas reports them
    ptxas = {name: [line.strip().split("'")[1] if "entry function" in line
                    else line.split(":", 1)[-1].strip()
                    for line in text.splitlines()
                    if "entry function" in line or "registers" in line or
                    "spill" in line]
             for name, text in kernels.build_log.items()}
    emit({"phase": "build", "seconds": build_s, "built": built,
          "ptxas": ptxas, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    phase_native()
    device = torch.device("cuda")
    generator = torch.Generator(device=device).manual_seed(0)
    records = phase_kernels(device, generator)
    paged = phase_paged_kernel(generator)
    counts = phase_slice()
    surface = phase_surface(smi)
    pipeline_counts, pipeline_tokens = phase_pipeline()
    with native_routing("remote_pipeline"):
        remote_counts, remote_tokens = phase_remote_pipeline()
    with native_routing("peer_pipeline"):
        peer_counts, peer_tokens = phase_peer_pipeline(remote_tokens)
    with native_routing("peer_chaos"):
        chaos_counts, _ = phase_peer_chaos(peer_tokens)
    phase_cli()
    phase_counts = {"slice": counts, "pipeline": pipeline_counts,
                    "surface": {"flash_attention": surface,
                                "cross_decode_attention": 0},
                    "remote_pipeline": remote_counts,
                    "peer_pipeline": peer_counts, "peer_chaos": chaos_counts}
    # paged launches by (variant, path): the native decoder decodes, the
    # int8 one decodes with scales folded and extends dequantizing
    llama_launches = phase_llama()
    counts = {("paged_decode_attention", "decode"): llama_launches}
    phase_llama_f32()
    int8_counts = phase_llama_int8_chunked()
    counts[("paged_decode_attention_int8_fold", "decode")] = \
        int8_counts["paged_decode_attention_int8_fold"]
    counts[("paged_decode_attention_int8_dequant", "extend")] = \
        int8_counts["paged_decode_attention_int8_dequant"]
    phase_llama_int8_f32()
    agent, agent_reference = phase_agent()
    counts[("paged_decode_attention", "extend_512")] = agent["extend"]
    phase_agent_f32()
    phase_assistant()
    phase_detect("raw")
    phase_detect("dct8")
    phase_detect_f32()
    phase_classify()
    gap_run = phase_llama_dense()
    spec_counts = phase_llama_spec(gap_run)
    for k, launches in spec_counts.items():
        counts[("paged_decode_attention", f"verify_w{k + 1}")] = launches
    spec_int8 = phase_llama_spec_int8()
    counts[("paged_decode_attention_int8_fold", "verify_w3")] = \
        spec_int8["paged_decode_attention_int8_fold"]
    counts[("paged_decode_attention_int8_dequant", "extend")] += \
        spec_int8["paged_decode_attention_int8_dequant"]
    phase_decoder_f32()
    phase_agent_dense()
    with tempfile.TemporaryDirectory() as directory:
        paths = phase_tts(directory)
        phase_tts_f32(paths)
    phase_media()
    counts[("paged_decode_attention", "decode")] += phase_llama_moe()
    phase_llama_moe_f32()
    tiered = phase_agent_tiered()
    phase_agent_tiered_f32()
    quantized = phase_llama_wq()
    phase_llama_select()
    chaos = phase_decoder_chaos()
    for run in (tiered, quantized, chaos):
        counts[("paged_decode_attention", "decode")] += run["decode"]
        counts[("paged_decode_attention", "extend_512")] += \
            run.get("extend", 0)
    disagg, disagg_probe = phase_disagg()
    variants = phase_disagg_variants()
    phase_disagg_f32()
    agent_disagg, disagg_tokens = phase_agent_disagg()
    migrate, migrate_tokens = phase_agent_migrate()
    migrate_mesh = phase_agent_migrate_mesh(migrate_tokens)
    for run in (disagg, variants, agent_disagg, migrate, migrate_mesh):
        for key, launches in run.items():
            counts[key] = counts.get(key, 0) + launches
    ops = phase_ops()
    counts[("paged_decode_attention", "decode")] += ops
    paged += phase_paged_kernel(generator, head_dim=128)
    counts[("paged_decode_attention", "decode_d128")] = phase_llama_8b()
    phase_llama_8b_f32()
    agent_mesh = phase_agent_mesh(agent_reference)
    counts[("paged_decode_attention", "decode")] += agent_mesh["decode"]
    counts[("paged_decode_attention", "extend_512")] += agent_mesh["extend"]
    agent_8b = phase_agent_8b()
    counts[("paged_decode_attention", "decode_d128")] += agent_8b["decode"]
    counts[("paged_decode_attention", "extend_d128")] = agent_8b["extend"]
    phase_agent_8b_f32()
    for key, launches in phase_agent_mesh_modes(disagg_tokens).items():
        counts[key] = counts.get(key, 0) + launches
    phase_counts["asr_mesh"] = phase_asr_mesh(pipeline_counts,
                                              pipeline_tokens)
    elements_mesh = phase_elements_mesh()
    operator_scripts = phase_operator_scripts()
    golden = phase_golden()
    examples = phase_examples()
    earlier = {phase: phase_counts[phase]["flash_attention"] for phase in
               ("slice", "surface", "pipeline", "remote_pipeline",
                "peer_pipeline", "peer_chaos", "asr_mesh")}
    earlier.update({
                    "llama": llama_launches,
                    "int8_fold":
                        int8_counts["paged_decode_attention_int8_fold"],
                    "int8_dequant":
                        int8_counts["paged_decode_attention_int8_dequant"],
                    "agent_tiered": tiered["decode"] + tiered["extend"],
                    "llama_wq": quantized["decode"],
                    "decoder_chaos": chaos["decode"] + chaos["extend"],
                    "disagg_probe": disagg_probe,
                    "disagg_variants": sum(variants.values()),
                    "agent_disagg": sum(agent_disagg.values()),
                    "agent_migrate": sum(migrate.values()),
                    "agent_migrate_mesh": sum(migrate_mesh.values()),
                    "elements_mesh": elements_mesh,
                    "operator_scripts": operator_scripts,
                    "golden": golden, "examples": examples,
                    "ops": ops,
                    "agent_8b": agent_8b["decode"] + agent_8b["extend"]})
    if earlier != EARLIER_COUNTS:
        raise AssertionError(f"earlier phases' counts {earlier} != "
                             f"{EARLIER_COUNTS}")
    phase_grad_guard()
    phase_train()
    phase_train_f32()
    phase_train_mesh()
    phase_checkpoint()
    phase_sp_prefill()
    phase_counts["staged"] = {"flash_attention": phase_staged(),
                              "cross_decode_attention": 0}
    import torch.distributed as dist
    dist.destroy_process_group()
    for record in records:
        record["launches"] = sum(phase_counts[phase][record["counter"]]
                                 for phase in record["counted_in"])
    for record in paged:
        record["launches"] = counts.get((record["variant"], record["path"]),
                                        0)
    records += paged
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(smi, flush=True)
    emit({"kernels": [{key: record[key] for key in keys}
                      for record in records]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
