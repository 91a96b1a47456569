#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing one line and failing the script (non-zero exit, no
final line) if anything is wrong:

  1. device    the card's name and power limit (nvidia-smi)
  2. build     compiles ops/csrc/*.cu with nvcc into build/ray_tpu_torch/
               (and, beside it, the runtime's C++ engine, store and fast lane
               with g++ into build/ray_tpu_torch/native/);
               ptxas's registers, spills and shared memory per kernel (the
               three TMA/wgmma kernels and the RMSNorm kernels must not
               spill); phase 30, which needs no kernel of the port, runs
               beside it
  3. kernels   each hand-written kernel against its plain PyTorch version at
               the JAX test shapes and the shapes the serving and training
               paths give it, with the kernel's, the plain version's and one
               library call's times (the median of five windows, with the
               lowest and highest) and the card's least time for the same
               work (the bound); bf16 at head_dim 128 reaches the TMA/wgmma
               forward, dQ and dK/dV kernels, f32 and head_dim 32/64 the
               mma.sync ones, and the route each C entry point reports is
               held against flash_attention.kernel_route; the backward's
               yardstick is SDPA's backward under the fastest of its
               backends; the RMSNorm forward and backward kernels at every
               shape of RMSNORM_CHECKS, each with its torch.profiler device
               time beside the events window, the backward's yardstick
               PyTorch's own fused RMSNorm backward; then every other input
               the reference takes (FLASH_INSTANTIATIONS: head_dim 16 in
               f32, bf16 and f16, f16 at head_dim 64 and 128, bf16 at
               head_dim 64 (BERT-base's heads, phase 23), head_dim 80
               zero-padded to 128, head_dim 256 in f32, bf16 and f16,
               head_dim 192 zero-padded to 256, head_dim 512 in f32, bf16
               and f16, head_dim 320 zero-padded to 384; RMSNORM_INSTANTIATIONS:
               dim 64, dim 50, f16, bf16 x with an f32 weight, bf16 at dim
               768), forward and backward, each an entry of its own in the
               kernels line
  4. serve     TransformerConfig.llama2_7b() at full width and depth in bf16
               behind the @batch decorator (buckets 1, 4, 8) as
               release/serve_bert_http.py serves its encoder: 12 concurrent
               requests of 512 tokens, each checked against its own
               unbatched forward
  5. generate  4 prompts of 32 tokens through the KV cache token by token,
               checked against forward at the last prompt step, then 32
               greedy tokens
  6. launches  the kernels' launch counts over phases 4 and 5, which must
               match the layers the path ran; every flash forward must
               have taken the wgmma route
  7. train     bench.py's train step at its full config (dim 4096, 3
               layers, hidden 16384, vocab 8192, 12 x 1024 tokens, bf16)
               through ray_tpu_torch.train.step: one step's loss and
               gradients against the same model with plain attention, one
               warm-up and 10 timed steps on one batch (the loss must
               fall), tokens/s, MFU, peak memory, one profiled step and a
               forward/backward/optimizer split; then the launch counts over
               the phase, which must match the steps it ran, every flash
               forward, dQ and dK/dV launch on the wgmma route; the plain
               side of the gradient check also takes the norm's plain
               backward, so the check holds the RMSNorm backward kernel
               inside the model
  8. tiny      TransformerConfig.tiny(attention="flash") (f32, head_dim 16):
               forward and one step's gradients through the kernels against
               plain attention, then train steps; every flash launch on the
               mma.sync route
  9. moe_serve llama2_7b(moe=MoEConfig(), n_layers=4) (dim 4096, hidden
               11008, 8 experts, top-2, bf16) behind @batch as in phase 4:
               finite answers, each bucket's answers bitwise equal to a
               direct forward on the same padded bucket, _moe_mlp's routing
               on the card equal to the CPU's, prefill tokens/s, the
               bucket-8 forward's wall and device time and the MoE einsums'
               share of it
 10. stages    partition_stages of those parameters into 2 stages, the
               stage_forward chain against forward, merge_stages back to the
               same tree
 11. moe_train llama2_7b(moe=MoEConfig(), n_layers=2), 4 x 1024 tokens: one
               step's loss and gradients against plain attention (with the
               tokens whose routing differs between the two), train steps
               whose loss falls, tokens/s, the split, peak memory and the
               step's matrix-product operations counted from their shapes
 12. sharded_train  bench.py's sharded config (bench.py:133-138: dim 4096,
               4 layers, hidden 16384, vocab 8192, 4 x 1024 tokens, bf16)
               through setup_sharded_training and build_sharded_train_step
               on a one-rank NCCL mesh {dp 1, fsdp 1, tp 1}: the budget
               check (llama2_7b in f32 refused before any allocation, in
               bf16 accepted), three steps against train_step from the same
               parameters and batch (bitwise, or within SHARDED_LOSS_TOL and
               SHARDED_UPDATE_TOL), then a warm-up and 10 timed steps of
               each (the loss must fall), tokens/s and peak memory; the
               tensor-parallel and fsdp collectives must be counted
 13. collectives  a one-rank NCCL collective group (util.collective): every
               op with the reference's world-size-1 semantics, the
               refusals, and the bucketed asynchronous gradient sync against
               sync_gradients; the group and its process group destroyed
 14. trainer   TorchTrainer with one GPU worker (a gang member actor in a
               placement group on ray_tpu_torch.init(num_cpus=8), leasing
               the card from the node agent, NCCL)
               at phase 12's config cut to 2 layers and its mesh: 6 steps, a
               report each, a save_sharded_state checkpoint at step 3
               committed by the trainer; in the first run the worker, after
               step 4's report, arms the chaos fail point
               train.checkpoint.mid_save (_private/chaos.py) and saves: the
               fault ends the process between the shards and the commit
               marker, the torn directory fails verify_sharded_checkpoint,
               the chaos log holds that one event, the trial's latest
               committed checkpoint stays step 3's, and the trainer restarts
               from it; a second run has no failure. Resumed steps 4-6
               must equal the second run's bitwise (losses and the final
               parameters' bits), and the parameters' bits must differ
               before step 1, after it and after step 6; checkpoint
               bytes, save and restore
               seconds (GB/s), the restart's wall time, gang formation, and
               the step time beside phase 12's (at 4 layers)
 15. sequence_parallel  ring and Ulysses attention (ray_tpu_torch.parallel.
               ring_attention) on 4 ranks run as threads on the card
               (ThreadGroup: the port's wire for ranks that share one card)
               at bench.py's train config (bench.py:561-565: 12 x 1024
               tokens, 32 heads of 128, bf16): 256 tokens a rank for ring,
               8 heads a rank over 1024 tokens for Ulysses, causal and
               full; O, dQ, dK and dV against flash_attention over the whole
               sequence and against the plain version (O within BF16_TOL,
               the gradients within BWD_REL_TOL of the largest); then one
               forward and backward of that model with attention=
               make_ring_attention(...) on the 4 ranks, each with a quarter
               of every sequence at its global positions, against the whole
               sequence through flash (loss and each gradient leaf as phase
               7 holds them); ring chunks on B1, B2 and B3
 16. pipeline  two PipelineStageRunners (S=2, v=2, M=8) on 2 thread ranks
               at bench.py's sharded config (4 layers, 16 x 1024 tokens,
               AdamW), as bench.py's _bench_pp runs it: one step against
               the fused microbatched step from the same parameters and
               batch (bitwise, or within SHARDED_LOSS_TOL and
               SHARDED_UPDATE_TOL), then timed steps of each: tokens/s,
               each rank's fwd/bwd/opt/pp_bubble seconds and the bubble's
               share against bubble_fraction(2, 8, 2)
 17. expert_parallel  phase 11's MoE model (llama2_7b(moe=MoEConfig(),
               n_layers=2), 8 experts, bf16, 4 x 1024 tokens) on 4 thread
               ranks of ep (ThreadGroup), each holding 2 experts' shard,
               against one rank on the same weights and batch with the
               routing pinned: the loss within EP_LOSS_REL_TOL relative,
               each gradient leaf within BWD_REL_TOL by relative Frobenius
               norm, the replicated leaves' gradients equal on every rank;
               then AdamW steps of each (the loss must fall), tokens/s,
               peak memory and a profiled ep step
 18. lora      release/train_llama_lora.py --full: TransformerConfig.
               llama2_7b(max_seq=2048) in bf16 at full width and depth,
               batch 1 x 2048, rank 8 on wq and wv, AdamW(1e-4) on the
               adapters alone: lora_forward equal to forward at init
               (bitwise), steps whose loss falls, tokens/s, peak memory and
               a profiled step, then the adapters' gradients against plain
               attention and the norm's plain backward (as phase 7)
 19. cnn       CNNConfig() at batch 64 and ResNetConfig() (ResNet-18
               layout, width 64, 32 x 32 x 3) at batch 128, f32 with TF32
               off: the first step's logits against the CPU's, Adam(1e-3)
               steps whose loss falls, img/s from the median step; no
               kernel of the port runs
 20. rllib     the RLlib learner (ray_tpu_torch.rllib) on the card, f32
               with TF32 off: a PPOLearner for ConvModule's Atari stack
               ([[32,8,4],[64,4,2],[64,3,1]] + 512 on uint8 [84, 84, 4],
               Discrete(6); release/rllib_ppo_atari_shaped.py's minibatch
               128) and one for MLPModule at CartPole's (64, 64)
               (release/rllib_ppo_cartpole.py's minibatch 256), each
               against a CPU learner from the same parameters on one
               seeded minibatch: the loss and each metric within
               RL_METRIC_TOL, each parameter leaf after the update within
               RL_PARAM_REL_TOL by relative Frobenius norm; then the
               update's time (CUDA events), its device time, kernels and
               idle share from one profiled update, the update's operations
               and their bound, one GAE bootstrap call's wall time, peak
               memory; then the learner's half of one Atari-shaped
               iteration (GAE with its bootstrap calls counted, the
               minibatch epochs, the weights fetched for the sync); no
               kernel of the port runs. The env runners and env-steps/s
               need gymnasium, which the card's machine lacks (RL_GYMNASIUM)
 21. rllib_offpolicy  RLlib's second slice on the card, f32 with TF32 off,
               each case at the widths the repo configures for it
               (OFFPOLICY_CASES): IMPALA on phase 20's Atari-shaped
               ConvModule (one fragment of 4 envs x 50 steps) and on
               CartPole's MLP (4 x 64), APPO on the Atari-shaped fragment
               for 5 updates (the target sync and the adaptive KL
               coefficient act), DQN (double-Q, its target tree, batch 64),
               SAC and CQL (SACModule (256, 256) on Pendulum's spaces, batch
               256, the step's noise drawn on the CPU and handed to both),
               BC and MARWIL (MLP (64, 64), 256), and multi-agent PPO (two
               modules through MultiAgentLearnerGroup.update_module), each
               against a CPU learner from the same parameters on the same
               batch: every metric (DQN's per-sample |TD| too) within
               RL_METRIC_TOL, every leaf, target trees included, within
               RL_PARAM_REL_TOL, the KL coefficients equal; then each
               update's time, device time, operations, idle share and top
               device operations, and its bound (SAC and CQL counted pass
               by pass); then IMPALA's learner half on the Atari-shaped
               fragment: the bootstrap call, V-trace on the host alone and
               as its round trip inside the update, and its share of the
               update; no kernel of the port runs
 22. profiler  the step profiler (ray_tpu_torch._private.profiler,
               train.step_stats): (a) phase 7's cell (bench.py:561-565)
               through setup_sharded_training on a one-rank NCCL mesh and
               the split step (fwd, bwd, grad_sync and opt scopes), a
               StepRecorder boundary a step, a capture of steps 2-3 of 5:
               in its torch.profiler trace each ProfilerStep window holds
               every B1-B4 and B4-bwd launch under the scope its phase
               implies (B1 and B4 under fwd, B2, B3 and B4-bwd under bwd,
               AdamW's kernels under opt, no compute under grad_sync), as
               many as the wrappers' counters over the same window; the
               top 8 device operations by time under each scope, the
               capture's cost on a step and the trace's size; (b)
               TorchTrainer with one GPU worker running phase 14's loop (6
               steps, the split step, no save), traced (the worker inherits
               RAY_TPU_tracing_enabled and RAYTPU_SESSION_DIR), and
               capture_profile(steps=2) from a driver thread: the merged
               trace's trace_ids non-empty, each a span in the session's
               span files (the worker's execute span), status ok, its 2 step
               slices on rank 0 with the phase slices inside, the worker's
               trace holding B1-B4, each report's device_kind the card's
               name, the worker's hbm_stats() within the card's memory and
               at least what it allocated; (c) a one-rank hier group and
               SliceTopology({"tp": 1}, {"dp": 1}) mesh: allreduce_sharded
               of one shard, the two tiers' sum and grad_psum(topology=)
               bitwise equal to their input
 23. serve_http  BASELINE config 4 exactly as release/serve_bert_http.py
               sets it, its non-tiny branch uncut, through the port's serve
               plane (ray_tpu_torch.serve): BERT-base widths (vocab 30522,
               dim 768, 12 layers of 12 heads, hidden 3072, bf16, random
               weights from the seed) behind @batch (8, 5 ms, buckets 1, 4,
               8, each warmed at init), max_ongoing_requests 64, autoscaled
               from 1 to 2 replicas (target 8 ongoing, upscale delay 1 s),
               on ray_tpu_torch.init(num_cpus=8): the controller, the HTTP
               proxy and each replica runtime actors, each replica leasing
               half of the card from the node agent (num_gpus 0.5);
               16 keep-alive http.client clients in a process of their own
               post the release script's payload for 8 s (then 4 s bursts
               until the second replica runs, at most 90 s), and a burst in
               which one replica profiles 1 s of its serving loop; 8 seeded
               requests, and 32 tokens of TokenStreamer as SSE. Every answer
               within LOGITS_TOL of a direct forward here, no request failed,
               2 replicas reached, 32 SSE tokens, each replica's lease "0",
               device 0 and weights on cuda:0 read inside it; qps,
               p50/p95/p99, the time to the second replica, batch occupancy,
               SSE tokens/s, the replica's device idle share and the proxy
               actor's CPU a request
 24. tune      the port's Tune (ray_tpu_torch.tune), each trial a process of
               its own: (a) BASELINE config 3 as release/tune_asha_resnet.py
               defines it (the ResNet at width 8 or 16 with one block a
               stage, Adam, 32 seeded images, 8 epochs of 4 steps; a grid
               of lr {1e-2, 1e-3, 1e-4} x width {8, 16} under
               ASHAScheduler(grace 2, max_t 8, reduction 2), the port's
               default concurrency), f32 with TF32 off: 6 trials, no error,
               each ending at iteration 2, 4 or 8, the controller's
               decisions equal to a fresh ASHAScheduler's on the stream it
               recorded, best_acc the highest last acc, and lr 1e-3 width
               8's first report within ASHA_LOSS_TOL of the same epoch on
               the CPU here (accuracy equal); num_trials, early_stopped,
               best_acc, best_config, the wall time and each trial's time
               to its first result; (b) Tuner(TorchTrainer) over lr {1e-2,
               1e-3, 1e-4}, one GPU worker a trial, three at once:
               ResNet-18 at batch 128, 8 reports of 4 Adam steps under ASHA
               on the loss; each trial's img/s from its median step, peak
               memory, the times from its start to its gang ready and to
               its first report; the reports reach the Tuner through the
               trainer's callbacks (training_iteration 1..n), each stopped
               trial's gang member gone within GANG_GONE_S of its stop, the
               trials' actors and members gone within GANG_GONE_S of fit();
               the trials are runtime actors on init(num_cpus=8), (a)'s
               leasing 1/8 of the card each, (b)'s members a third each,
               the three at once
 25. elastic   the trainer's gangs on the runtime (init(num_cpus=8) for
               (a) and (b), with 4 trainslots for (c)): (a) BASELINE config 1 as
               release/train_fashion_mnist.py runs it (two CPU workers,
               CNNConfig(), batch 64, Adam 1e-3, one warm-up and 30 steps,
               one report with a checkpoint), then one GPU worker from the
               same params and batch, its first step's logits within
               CNN_LOGITS_TOL of the CPU worker's; img/s of each; (b)
               ScalingConfig(num_workers=2, min_workers=1, use_gpu=True,
               elastic_formation_timeout_s=2) on the one card: the group of
               2 cards waits out the 2 s unplaced and the gang forms at 1, phase
               14's loop at one layer reads its token batches from a
               Dataset shard (TorchTrainer(datasets=), 16 seeded rows of
               release_loops.token_rows) and checkpoints step 1 with the
               shard's position (ingest.json), its worker exits hard after
               that report, the gang re-forms at 1 and resumes ingest from
               the record; the resumed steps bitwise equal to a fixed
               world-1 run's, the rows consumed over the death and the
               resume the dataset's, at most 3 batches a rank read twice;
               the step-down wait, each formation, the restore and the
               run's goodput buckets; (c) release/benchmarks_elastic.py's
               churn at its smoke scale (10 steps of 0.05 s, the kill at
               step 3) on 4 CPU gloo workers with min_workers 2, each
               leasing one of 4 declared trainslots (the churn holds the
               killed rank's from an actor): the churned run must
               step down, grow back to 4 and reproduce the undisturbed
               run's losses exactly; its keys, and each gang's timeline
 26. data      ray_tpu_torch.data on a pool of 4 data worker processes
               (_private.local_tasks, no CUDA device in them): (a) range(60000)
               -> map_batches(release_loops.fashion_mnist_rows) (each row's
               seeded 28x28x1 f32 image and int64 label, Fashion-MNIST's
               train-split shape) -> random_shuffle(seed=0) -> one epoch of
               iter_batches(batch_size=64), each stage timed: the pool's
               start, rows/s and the shuffle's wall; the epoch's ids a
               permutation of range(60000) and every image and label equal
               to fashion_mnist_rows of its id computed here; (b) BASELINE
               config 1's loop (batch 64, Adam 1e-3) on one card worker
               through TorchTrainer(datasets=), one epoch of (a)'s rows
               (937 steps) from get_dataset_shard("train").
               iter_torch_batches: img/s beside phase 25's fixed-batch
               figure, and the ingest share of a step from the StepStats
               records' data wait; the pool stopped and its store removed
 27. serve     the serve plane's multiplexing and reliability: (a) phase
     reliab.   23's encoder as a multiplexed deployment (2 replicas at
               num_gpus 0.5, @serve.multiplexed(max_num_models_per_replica
               =2), each model's weights from a seed its id gives, unload
               freeing them and checkpoint counted), 16 closed-loop driver
               threads for 6 s drawing model ids m0-m3 40/30/20/10 through
               handle.options(multiplexed_model_id=...): qps, p50 and p99 of
               cache hits and misses, loads and evictions a replica, each
               model's share on its busiest replica, each replica's memory
               against 2 models' bytes; every answer within LOGITS_TOL of a
               direct forward of its model's weights, at most 2 models a
               replica, checkpoint before unload on every eviction; (b)
               release/benchmarks_serve_chaos.py's phases 1-2 deployed by
               serve.run_from_config from a YAML (2 replicas at num_gpus 0.5,
               max_ongoing_requests 32, request_timeout_s 30, retry_policy
               {max_attempts 8, hedge}, health checks every 1 s; two HTTP
               proxies, each an actor the controller restarts; each of (a)
               and (b) on its own ray_tpu_torch.init(num_cpus=8)): 8
               clients in a process of their own, each preferring its proxy
               and failing over to the other, honouring 503 Retry-After, a 4 s
               baseline then a 4 s window that SIGKILLs a replica (1 s) and the
               second proxy (2.5 s); the bench's gates: lost 0, both kills
               landed, the replica replaced, the proxy back on its port, chaos
               p99 under 3x the baseline's; the hedges, breaker states and
               the route p99 the controller scraped. The oom_risk drain (the
               bench's phase 3) waits for ROADMAP Queue A item 14d
 28. dag       compiled graphs (ray_tpu_torch.dag) on the local actors
               (_private.local_tasks, every actor of the phase started at
               once, all stopped at its end): (a) TransformerConfig.
               llama2_7b() at full width in bf16, its depth cut to 8
               layers, as two stage actors (_private.dag_apps.
               TransformerStage) at num_gpus 0.5 each, each building the
               tree from the seed and keeping its 4 layers (checksums
               against the driver's partition_stages),
               compiled as InputNode -> stage0.forward -> stage1.forward on
               device edges ([8, 512] int64 tokens in, the [8, 512, 4096]
               bf16 hidden state as a CUDA IPC edge, the last position's
               f32 logits [8, 32000] out): one warm execution, 16 with up
               to CHANNEL_DEPTH in flight, 16 one at a time, each held
               against the driver's own stage_forward chain (bitwise or
               within LOGITS_TOL, the largest difference printed), the 3
               executions after the warm one each under a driver span (the
               actors start traced): one trace id from the driver's inject
               through the input edge, both stages' dag.stage spans, the
               CUDA edge's channel.push (stage 0) and channel.pop (stage 1,
               under that push) and the output edge, whose context the
               driver's reader keeps (last_trace); each
               actor's launches held to its layers and none in the driver
               during the executions; tokens/s pipelined, sequential and of
               the driver's chain, each actor's start, peak and
               memory_allocated against its stage's bytes, the compile's
               seconds; (b) release/benchmarks_dag.py's hop (a 1-stage echo
               graph on device edges against the raw two-rank exchange on
               the same kind of group, 4 MiB of host float32 and of CUDA
               float32, 80 reps; and the 32 MiB hidden state through the
               echo) and rpc (3 relays by ordinary calls against the same
               relays compiled onto shm: messages to actors a step, 0 for
               the graph); (c) release/benchmarks_dag_recovery.py: an
               unsupervised and a supervised 3-relay shm chain's step, then
               the middle relay killed with CHANNEL_DEPTH executions in
               flight: lost 0, duplicates 0, one recovery, its seconds and
               the replays discarded
 29. ring      the host-side collectives (ray_tpu_torch.util.collective):
               (a) the block-scaled codec on the card, int8 and fp8 at block
               256, on a seeded flat gradient of bench.py's sharded config's
               size (1,140,887,552 f32): encode and decode times by CUDA
               events, the encode's bytes bound, and q, the scales, the
               decoded values and the error-feedback residual after two
               encodes bitwise against the numpy plain version on a 64M
               slice (its seconds beside); (b) TorchTrainer(backend="ring")
               at that config, two members sharing the card ({"GPU": 0.5}
               each, a gloo process group, no NCCL), each on its own seeded
               4 x 1024 batch, the split step over mesh {dp 2}: 2 steps on
               the exact wire (the synced gradient bitwise the f64 sum of
               both ranks' at 1M seeded indices), then 6 steps each of int8
               and fp8 with the bucketed overlap (parameters bitwise equal
               across the ranks every step, losses within 2% of the exact
               run's, falling, wire bytes at most 0.3x), the int8 run traced:
               every flight record of a user-visible op joined to exactly one
               collective span (comm_seq and comm_channel on the span, its
               trace id on the record), bytes and wire_bytes on each span,
               a rank's wire_bytes summing to what its ring sent, and rank 1
               arming a 1 s window of the latency point
               collective.allreduce.rank1 at step 3 (its chaos log holds the
               events, each inside the window; rank 0's allreduce of the op
               it held back ends only after rank 1 wakes); step time,
               tokens/s, grad_sync, collective and exposed comm, wire
               bytes, peak memory, gang formation, stalls (0), launches;
               (c) bench.py --overlap on two CPU ring members, on and off,
               with identical loss trajectories
 30. serve_llm (run beside phase 2's build, before phase 3)
               the serve-LLM engine (ray_tpu_torch.serve.llm): first an int8
               and an fp8 KV payload decoded on the card (decode_device) into
               a KVBlockPool there, bitwise against decode_plain on the host;
               then release/benchmarks_serve_llm.py's phases 1-3 on
               ray_tpu_torch.init(num_cpus=32), its
               deployment uncut (1 prefill replica on the host, 2 decode
               replicas at a quarter of the card each, max_slots 128, buckets
               32/64/128, 4096 KV blocks of 16 x 16 f32 on the card, the int8
               wire, hedging, health checks every 1 s, two proxies) under the
               bench's full load in 4 s windows: (1) a baseline of 8 handle
               threads sending generate_batch waves of 64 and 2 HTTP clients,
               with steady_rpc_probe on a decode replica (0 calls to the
               runtime's controller, less its metrics flush and task-event
               report, in a whole window of 100 iterations; the baseline
               runs on past 4 s until the probe returns); (2) a window
               at 2 handle threads and 2 HTTP clients that SIGKILLs a decode
               replica (1 s)
               and the second proxy (2 s), then the wait for both back; (3)
               the bench's tiny-pool app (2 tokens a block, 64 blocks,
               kv_headroom_min 0.8 on decode only), whose decode pool must grow
               from 1 to 2 while prefill stays at 1. Gates: lost 0, every
               sequence's tokens equal to the digest, both kills landed and
               recovered, decode_controller_rpcs 0, pools_scale_independent 1,
               every decode pool on the card and each decode replica's
               lease and current device read inside it; sequences/s beside the
               reference's full-load release gate of 3,800, the p99s and
               their ratio. The phase runs traced with every sequence
               sampled: one request sent before the load with an
               X-RayTPU-Trace header keeps the header's trace id from the
               proxy's serve.request through the decode replica's span,
               serve.prefill, the prefill replica's span and
               serve.kv_transfer to its 4 decode.iter spans, its timeline
               record carries it and its build_sequence_trace view is
               written and parses; the KV device wire (two ring ranks in
               this process, the int8 payload decoded on the card) hops
               under its serve.kv_transfer span; decode.iter spans come
               from both decode replicas. Then the observability bench's
               phase 1 in this process (release/benchmarks_serve_llm_
               observability.py, 24 ABBA pairs of windows, the KV pool on the
               card): overhead_pct held to 10% (the bench gates 2%)
 31. runtime   the runtime core (ray_tpu_torch.init/remote/get/put/wait/kill)
               on this host, init() with no arguments: (a) cluster_resources
               shows GPU 1 and the card's name key, neither the controller
               nor the node agent holds a CUDA context (nvidia-smi's compute
               apps, and no /dev/nvidia* file open where the model actor's
               process has them), and the engine, the fast lane (or its printed reason)
               and the agent's lease lane are on; (b) two num_gpus=0.5 tasks
               at once on the card, each seeing CUDA_VISIBLE_DEVICES=0 and
               launching B4 once against its plain version, and a CPU task
               seeing "" and no CUDA; (c) a num_gpus=1 actor that builds
               llama2_7b() (32 layers, bf16, seed 0) on its card answers 3
               forward calls on a put [8, 512] int32 batch with the full f32
               logits as CUDA tensors, each bitwise equal (digest of the
               bits) to the logits it computed at construction, with its
               launches (3 x 32 of B1 on wgmma, 3 x 65 of B4), the call's
               time and its forward, device-to-host and host-to-device
               shares; (d) 1 GiB of CPU bf16 and 1 GiB of numpy put (GB/s),
               read back as zero-copy read-only views, and summed on the
               card by the actor as the driver sums them; (e) the actor
               killed and its lease back within 10 s, a num_gpus=1,
               max_restarts=1 probe SIGKILLed (answers again on the card
               from a new pid) and SIGKILLed again (ActorDiedError, lease
               back); (f) _private/ray_perf.py's tasks/s and actor calls/s;
               shutdown() leaves no process and no /dev/shm/raytpu_torch-*
Each path (4-5, 7, 8, 9, 10, 11, 12, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
27, 28, 29, 30, 31) runs with every launch count set to 0 just before it; its counts, read just after,
must equal what its layers and passes imply, every flash launch on the
route the path's inputs take. The trainer path's kernels launch in its
worker processes, and the HTTP serving path's in its replica actors,
whose counts start at 0 with each process and come back in their reports
and through each replica's kernel_launches (phase 27's too, each
replica's held to its own forwards);
so do the Tune trials' (phase 24, where every count is 0),
the elastic trainer's (phase 25), the graph's stage actors' (phase 28),
the ring members' (phase 29) and the runtime's model actor's (phase 31).

What phases 14, 22, 28, 29 and 30 showed of tracing and chaos, and their
walls beside the previous recorded run's, make the "observability" line
before the summary.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import pickle
import queue
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch as rt
from ray_tpu_torch import _build
from ray_tpu_torch import data as rd
from ray_tpu_torch._private import chaos as chaos_mod
from ray_tpu_torch._private import config as config_mod
from ray_tpu_torch._private import dag_apps, local_tasks
from ray_tpu_torch._private import profiler as profiler_mod
from ray_tpu_torch._private import resources
from ray_tpu_torch._private import worker as runtime_worker
from ray_tpu_torch._private import telemetry
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.models import transformer as transformer_mod
from ray_tpu_torch.models.transformer import (
    MoEConfig, TransformerConfig, decode_step, forward, init_kv_cache, init_params,
    logits_loss, loss_fn, merge_stages, num_params, param_logical_dims, partition_stages,
    stage_forward,
)
from ray_tpu_torch.ops import flash_attention as flash_mod
from ray_tpu_torch.ops import rmsnorm as rmsnorm_mod
from ray_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from ray_tpu_torch.parallel import _wire
from ray_tpu_torch.parallel import tensor_parallel as tp_mod
from ray_tpu_torch.parallel.mesh import MeshSpec, tree_map
from ray_tpu_torch.parallel.pipeline import (
    bubble_fraction, check_message_order, schedule_interleaved_1f1b, validate_schedule,
)
from ray_tpu_torch.parallel.ring_attention import (
    make_ring_attention, make_ulysses_attention, sequence_positions,
)
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOLearner, value_function
from ray_tpu_torch.rllib.connectors import GeneralAdvantageEstimation
from ray_tpu_torch.rllib.core.rl_module import ConvModule, RLModuleSpec
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTION_LOGP, ACTIONS, ADVANTAGES, EPS_ID, NEXT_OBS, OBS, REWARDS, TERMINATEDS, TRUNCATEDS,
    VALUE_TARGETS, VF_PREDS, SampleBatch,
)
from ray_tpu_torch.parallel.topology import SliceTopology
from ray_tpu_torch import serve, tune
from ray_tpu_torch.serve import batching as serve_batching
from ray_tpu_torch.serve import long_poll
from ray_tpu_torch.serve import routing as serve_routing
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve import llm
from ray_tpu_torch.serve.llm import deployments as llm_dep
from ray_tpu_torch.serve.llm import observability as llm_obs
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train import release_loops
from ray_tpu_torch.train import step_stats as step_stats_mod
from ray_tpu_torch.train import torch_utils
from ray_tpu_torch.train.checkpoint import StorageContext, verify_sharded_checkpoint
from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.stage_runner import PipelineStageRunner, microbatch_slicer
from ray_tpu_torch.train.step import make_optimizer, named_leaves, train_step
from ray_tpu_torch.train.torch_utils import (
    MemoryBudgetError, begin_gradient_sync, build_sharded_train_step, device_memory_budget,
    plan_sharded_training, restore_sharded_state, save_sharded_state, setup_sharded_training,
    sync_gradients,
)
from ray_tpu_torch.train.trainer import TorchTrainer
from ray_tpu_torch.tune.schedulers import ASHAScheduler
from ray_tpu_torch.util import collective as collective_mod
from ray_tpu_torch.util import timeline as timeline_mod
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.collective import bucketing as bucketing_mod
from ray_tpu_torch.util.collective import quantization as quant_mod
from ray_tpu_torch.util.chaos import FaultSchedule, read_event_log
from ray_tpu_torch.util.gang import WorkerGang


SEED = 0
# H100 SXM data-sheet peaks (dense): HBM bytes/s, and operations/s by type
# (bf16 and f16 on the tensor cores; f32 on the CUDA cores, as the kernels
# use it).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
# Kernel against plain version. Flash O is held by its absolute error, with
# the tolerances tests/test_ops.py holds the Pallas kernel to (the kernel
# rounds P to bf16 before P.V unnormalised, the plain version normalised,
# so bf16 O differs by more than rounding). RMSNorm's bf16 output is held
# in units in the last place of the plain result: both compute nearly equal
# f32 values and round once, so they may land one bf16 ulp apart and no
# more; a kernel that rounds an intermediate to bf16 lands further.
F32_TOL = 2e-5
BF16_TOL = 3e-2
RMSNORM_F32_TOL = 1e-5
RMSNORM_BF16_ULPS = 1.0
# RMSNorm backward against _rmsnorm_backward, each output by max |kernel -
# plain|. f32: over the plain result's largest magnitude, bound 1e-5: the
# row sums and dw's sum over rows are taken in another order, which moves
# them by a few f32 ulps of their terms' magnitude. bf16: in bf16 ulps of
# the plain result's largest magnitude, bound 1: both round nearly equal
# f32 values once, so an element lands at most one of its own ulps away,
# and no element's ulp is larger than the largest one's; f32 differences
# where dx cancels (g close to n * mean(g * n)) are far below that ulp. A
# kernel that rounds an intermediate to bf16, or drops a row of dw's sum,
# lands further.
RMSNORM_BWD_F32_TOL = 1e-5
RMSNORM_BWD_BF16_TOL = 1.0
# LSE: f32 sums in another order; |LSE| ~ log(seq) + O(1).
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3, torch.float16: 1e-3}
# bf16 logits of the 32-layer model (values of order 1): the batched and
# unbatched runs, and decode (f32 attention over the cache) against forward
# (flash, P in bf16), round at other places; different tokens differ by O(1).
LOGITS_TOL = 0.25
# Flash backward against its plain version. f32 is held to 2e-4 absolute,
# as tests/test_ops.py holds the Pallas backward; bf16 at head_dim 64 to
# 0.15 absolute, that test's bf16 bound (test_ops.py:164). bf16 at head_dim
# 128 (the wgmma dQ and dK/dV route) is held by max |kernel - plain| over the plain
# result's largest magnitude: at the training shape the gradients grow with
# the sequence, and at the small edge shapes their largest magnitude is
# below 1, where 0.15 absolute would let a dropped tile pass. Bound 2e-2:
# the outputs round to bf16 (2^-8 of the largest value at most), and P and
# dS are rounded to bf16 from f32 values whose last bits differ between the
# two sum orders; each flip moves one term of a sum by a bf16 ulp, and the
# flips add with random signs. A kernel that skips, repeats or transposes a
# tile is off by order 1.
BWD_F32_TOL = 2e-4
BWD_BF16_TOL = 0.15
BWD_REL_TOL = 2e-2
# The mma.sync kernels' times at the same shapes before the TMA/wgmma
# redesign, as PERF.md's kernel table records them. Printed on a line of
# their own, labelled as recorded: they are not measured by this run.
RECORDED_BEFORE_MS = {"flash_attention_fwd": 0.2261, "flash_attention_fwd_train": 1.029,
                      "flash_attention_bwd_dq": 1.6274, "flash_attention_bwd_dkv": 2.296}
RECORDED_BEFORE_SOURCE = ("PERF.md section 6: the mma.sync kernels before the TMA/wgmma "
                          "redesign, chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W")
SERVE_SEQ = 512
SERVE_REQUESTS = 12
BUCKETS = [1, 4, 8]
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_CACHE = 4, 32, 32, 128

_t_start = time.perf_counter()


_log_lock = threading.Lock()


def log(phase: str, **fields) -> None:
    line = f"[{time.perf_counter() - _t_start:7.1f}s] {phase}: {json.dumps(fields)}\n"
    with _log_lock:  # the build's thread logs beside phase 30's
        sys.stdout.write(line)
        sys.stdout.flush()


def time_ms(fn, iters: int = 20, windows: int = 5, warmup: int = 3) -> dict:
    """Device time of one call, from CUDA events around each of `windows`
    windows of `iters` calls: the median window ("ms"), and the lowest and
    highest ("range")."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return {"ms": statistics.median(times), "range": [min(times), max(times)]}


def bound(ops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Least time (ms) the card could take: operations or bytes, the larger."""
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# Significand bits (with the implicit one) of the 16-bit types: an ulp at
# |x| in [2^(e-1), 2^e) is 2^(e - bits).
SIGNIFICAND_BITS = {torch.bfloat16: 8, torch.float16: 11}


def ulps(out: torch.Tensor, plain: torch.Tensor) -> float:
    """max |out - plain| in units in the last place of plain, in plain's
    16-bit dtype."""
    ref = plain.float()
    _, exp = torch.frexp(ref.abs().clamp_min(2.0 ** -126))
    ulp = torch.pow(2.0, (exp - SIGNIFICAND_BITS[plain.dtype]).float())
    return float(((out.float() - ref).abs() / ulp).max())


def device_time(fn, top: int = 5) -> dict:
    """Device time of one call of fn, from torch.profiler's records of what
    ran on the card (kernels, copies): the total, and the `top` that took
    the most. Annotation ranges recorded on the device (the optimizer's
    step) span kernels already counted and are left out. The profiler
    slows the host, so the wall time to compare with comes from an
    unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    return {
        "device_ms": sum(r[1] for r in rows),
        "device_ops": sum(r[2] for r in rows),
        "top": [{"op": k[:60], "ms": ms, "count": n} for k, ms, n in rows[:top]],
    }


def per_call_device_ms(fn, calls: int = 20) -> float:
    """torch.profiler's device time of one call of fn: the mean over `calls`
    calls."""
    return device_time(lambda: [fn() for _ in range(calls)])["device_ms"] / calls


def _counts() -> dict:
    """Every kernel's launch count, under its name in the kernels line."""
    return {
        "flash_attention_fwd": flash_mod.flash_attention.launches,
        "flash_attention_bwd_dq": flash_mod._flash_bwd_dq.launches,
        "flash_attention_bwd_dkv": flash_mod._flash_bwd_dkv.launches,
        "rmsnorm": rmsnorm_mod.rmsnorm.launches,
        "rmsnorm_bwd": rmsnorm_mod.rmsnorm_backward.launches,
    }


def _route_counts() -> dict:
    """The launches of the kernels with two routes, by route."""
    return {
        "flash_attention_fwd": dict(flash_mod.flash_attention.launches_by_route),
        "flash_attention_bwd_dq": dict(flash_mod._flash_bwd_dq.launches_by_route),
        "flash_attention_bwd_dkv": dict(flash_mod._flash_bwd_dkv.launches_by_route),
    }


def _reported_route(fns, call, dtype, head_dim, what: str):
    """Runs `call`, which launches the kernel of each of `fns` once, and
    returns its result and the route the C entry points reported, which
    must be the one flash_attention.kernel_route states for (dtype,
    head_dim)."""
    before = [dict(fn.launches_by_route) for fn in fns]
    result = call()
    want = flash_mod.kernel_route(dtype, head_dim)
    for fn, counts in zip(fns, before):
        taken = {r: n - counts[r] for r, n in fn.launches_by_route.items() if n != counts[r]}
        require(taken == {want: 1},
                f"{what}: {fn.__name__} launched on {taken}, kernel_route says {want}")
    return result, want


def reset_counts() -> None:
    """Sets every kernel's launch count, and the tensor-parallel and sharded
    step's collective counts, to 0."""
    flash_mod.reset_launch_counts()
    rmsnorm_mod.rmsnorm.launches = 0
    rmsnorm_mod.rmsnorm_backward.launches = 0
    tp_mod.reset_calls()


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# Neither this script nor any process it starts may load JAX or the JAX
# package: main checks at its end, and the train loops of phases 14 and 25
# check in their worker processes after their last step.
REFERENCE_PACKAGES = ("jax", "jaxlib", "flax", "ray_tpu")


def require_no_reference(where: str) -> None:
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFERENCE_PACKAGES)
    require(not loaded, f"{where}: JAX or the JAX package was imported: {loaded}")


# ---------------------------------------------------------------- the runtime
# Every phase that forms a gang, a Tune trial or an RLlib actor runs it on a
# cluster of its own (ray_tpu_torch.init), started as the phase's release
# script starts its own; after the phase, what it started must be gone.
# The library actors whose processes a phase must leave ended.
LIBRARY_ACTORS = ("_GangMember", "_TrialActor", "_LearnerActor", "_SlotHolder")
# How long the processes and the node agent's resources may take to settle.
SETTLE_S = 10.0


def runtime_actors(class_names=LIBRARY_ACTORS) -> list:
    """The controller's records of the library actors started so far:
    class, state and process id."""
    ctx = runtime_worker.get_global_context()
    return [a for a in ctx.io.run(ctx.controller.call("list_actors", {}))
            if a.get("class_name") in class_names]


def require_settled(phase: str, free: dict) -> dict:
    """Within SETTLE_S: every library actor recorded dead and its process
    gone, no placement group left, and the node agent's free resources back
    to ``free``. Returns the actors' count and the seconds it took."""
    from ray_tpu_torch.util import placement_group as pgs

    t0 = time.monotonic()
    while True:
        actors = runtime_actors()
        live = [a for a in actors if a["state"] != "DEAD"]
        running = [a["pid"] for a in actors if a.get("pid") and _alive(a["pid"])]
        groups = [g["pg_id"] for g in pgs.placement_group_table() if g["state"] != "REMOVED"]
        avail = rt.available_resources()
        if not (live or running or groups) and avail == free:
            return {"actors": len(actors), "settle_s": time.monotonic() - t0}
        require(time.monotonic() - t0 < SETTLE_S,
                f"{phase}: {SETTLE_S} s after the phase, actors not dead {live}, processes "
                f"running {running}, placement groups {groups}, free {avail} against {free}")
        time.sleep(0.05)


def require_member_leases(phase: str, attempts: list, cards: int = 1) -> list:
    """Each formed gang's members (``Result.attempts``' ``members``, read
    inside each member): a GPU member sees only its lease's card, as
    ``cuda:0``. Returns the members' (CUDA_VISIBLE_DEVICES, current device)."""
    seen = [(m["cuda_visible_devices"], m["current_device"])
            for a in attempts for m in a.get("members", [])]
    require(seen and all(v not in (None, "") and len(v.split(",")) == cards and d == 0
                         for v, d in seen),
            f"{phase}: the members' leases and devices {seen}")
    return seen


@contextlib.contextmanager
def on_runtime(phase: str, **init_kwargs):
    """``ray_tpu_torch.init(**init_kwargs)`` for the phase; yields the
    cluster's session directory. After the phase (unless it raised), holds
    it to ``require_settled`` against the free resources before it; shuts
    the cluster down either way."""
    rt.init(**init_kwargs)
    try:
        free = rt.available_resources()
        yield runtime_worker.runtime_info()["session_dir"]
        SETTLED[phase] = require_settled(phase, free)
    finally:
        rt.shutdown()


# What require_settled found after each phase on the runtime.
SETTLED: dict = {}


# ---------------------------------------------------------------- tracing and chaos
# Phases 14, 22, 28, 29 and 30 also drive the port's tracing and chaos
# planes (util/tracing.py, _private/chaos.py) inside the processes they
# start anyway; what they find goes into OBSERVABILITY, printed as the
# "observability" line before the summary.
TRACE_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke_trace"
OBSERVABILITY: dict = {}
# Those phases' walls in the previous recorded full run, before they were
# traced (PERF.md sections 4 and 6; phase 22's was not recorded), printed
# beside this run's.
PREVIOUS_WALLS_S = {"trainer": 103.4, "profiler": None, "dag": 33.0, "ring": 120.4,
                "serve_llm": 46.4}
_TRACE_ENV = ("RAY_TPU_tracing_enabled", "RAYTPU_SESSION_DIR")


@contextlib.contextmanager
def traced(name: str):
    """Tracing on in this process and in every process started meanwhile
    (which inherit RAY_TPU_tracing_enabled and RAYTPU_SESSION_DIR), spans
    exported under TRACE_ROOT/<name>; yields that session directory, which
    the caller removes once it has read it."""
    session = TRACE_ROOT / name
    shutil.rmtree(session, ignore_errors=True)
    session.mkdir(parents=True)
    saved = {k: os.environ.get(k) for k in _TRACE_ENV}
    os.environ.update(RAY_TPU_tracing_enabled="1", RAYTPU_SESSION_DIR=str(session))
    cfg = config_mod.global_config()
    was = cfg.tracing_enabled
    cfg.tracing_enabled = True
    tracing.configure(str(session))
    try:
        yield str(session)
    finally:
        tracing.flush()
        cfg.tracing_enabled = was
        tracing._dir = None
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _spans_when(session: str, ready, timeout_s: float = 20.0) -> list:
    """The session's spans once ``ready(spans)`` holds, or at the timeout
    (other processes flush theirs every 0.2 s)."""
    deadline = time.monotonic() + timeout_s
    while True:
        spans = tracing.read_spans(session)
        if ready(spans) or time.monotonic() > deadline:
            return spans
        time.sleep(0.2)


def _span_counts(spans: list) -> dict:
    """Span counts by name, the parts after a space (paths, methods) cut."""
    out: dict = {}
    for s in spans:
        key = s["name"].split(" ")[0]
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


# ---------------------------------------------------------------- phase 1
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    return smi


# ---------------------------------------------------------------- phase 2
def _ptxas_report(text: str) -> dict:
    """Per kernel (mangled name) from nvcc -Xptxas=-v: registers, spill
    bytes and static shared memory."""
    report, name = {}, None
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = found.group(1)
            report[name] = {}
        elif name and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            report[name].update(spill_stores=int(stores), spill_loads=int(loads))
        elif name and "Used" in line and "registers" in line:
            report[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return report


def _build_native() -> dict:
    """The runtime's C++ engine, store and fast lane (phase 31), with g++
    beside nvcc's build."""
    from ray_tpu_torch import _native

    start = time.perf_counter()
    _native.build()
    _native.build_fastlane()
    return {"seconds": time.perf_counter() - start}


def phase_build() -> dict:
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(_build_native)
        _build.library()
        native = native.result()
    report = _ptxas_report((_build.BUILD_DIR / "build.log").read_text())
    wgmma = {name: info for name, info in report.items() if "wgmma" in name}
    norm = {name: info for name, info in report.items() if "rmsnorm" in name}
    log("build", seconds=round(time.perf_counter() - start, 2),
        nvcc_seconds=_build.build_seconds, native_gxx_seconds=native["seconds"],
        wgmma_kernels=wgmma, rmsnorm_kernels=norm,
        ptxas=report)
    require(len(wgmma) == 3, f"build: expected the three wgmma kernels in ptxas's report, {wgmma}")
    require(norm, "build: no RMSNorm kernel in ptxas's report")
    spills = {name: info for name, info in {**wgmma, **norm}.items()
              if info.get("spill_stores") != 0 or info.get("spill_loads") != 0}
    require(not spills, f"build: kernels that spill: {spills}")
    return report


# ---------------------------------------------------------------- phase 3
def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _causal_pairs(seq_q: int, seq_k: int, causal: bool) -> int:
    """(query, key) pairs the end-aligned causal mask leaves visible."""
    if not causal:
        return seq_q * seq_k
    offset = seq_k - seq_q
    return int(sum(min(max(i + offset + 1, 0), seq_k) for i in range(seq_q)))


# (name, batch, heads, seq_q, seq_k, head_dim, causal, dtype, tol): the JAX
# test shapes, ragged lengths no Pallas block divides, more queries than keys
# (rows that see no key), and every shape the main path gives the kernel:
# the serve buckets 1, 4 and 8 at 512 tokens, and generate's forward of 4
# prompts of 32 tokens, and the train step's 12 x 1024. The plain version's
# and the library's times are taken at FLASH_TIMED and FLASH_TRAIN.
FLASH_CHECKS = [
    ("s256_d64_causal", 2, 4, 256, 256, 64, True, torch.float32, F32_TOL),
    ("s256_d64_full", 2, 4, 256, 256, 64, False, torch.float32, F32_TOL),
    ("s128_d32", 1, 2, 128, 128, 32, True, torch.float32, F32_TOL),
    ("sq64_sk128", 1, 2, 64, 128, 32, True, torch.float32, F32_TOL),
    ("ragged_s100_d64", 1, 3, 100, 100, 64, True, torch.float32, F32_TOL),
    ("causal_sq130_sk70", 1, 2, 130, 70, 64, True, torch.float32, F32_TOL),
    ("ragged_sq37_sk200_bf16", 2, 2, 37, 200, 128, False, torch.bfloat16, BF16_TOL),
    ("gen_b4_h32_s32_d128_bf16", 4, 32, 32, 32, 128, True, torch.bfloat16, BF16_TOL),
    ("serve_b1_h32_s512_d128_bf16", 1, 32, 512, 512, 128, True, torch.bfloat16, BF16_TOL),
    ("serve_b4_h32_s512_d128_bf16", 4, 32, 512, 512, 128, True, torch.bfloat16, BF16_TOL),
    ("serve_b8_h32_s512_d128_bf16", 8, 32, 512, 512, 128, True, torch.bfloat16, BF16_TOL),
    ("train_b12_h32_s1024_d128_bf16", 12, 32, 1024, 1024, 128, True, torch.bfloat16, BF16_TOL),
    # The edges of the wgmma route (bf16 at head_dim 128): ragged causal
    # lengths, rows that see no key, lengths no 128-row tile divides, and a
    # long causal sequence.
    ("causal_sq37_sk200_bf16", 2, 2, 37, 200, 128, True, torch.bfloat16, BF16_TOL),
    ("causal_sq130_sk70_bf16", 1, 2, 130, 70, 128, True, torch.bfloat16, BF16_TOL),
    ("s200_causal_bf16", 1, 2, 200, 200, 128, True, torch.bfloat16, BF16_TOL),
    ("s200_full_bf16", 1, 2, 200, 200, 128, False, torch.bfloat16, BF16_TOL),
    ("s1000_causal_bf16", 1, 4, 1000, 1000, 128, True, torch.bfloat16, BF16_TOL),
    # More queries than keys over several key tiles: blocks whose first rows
    # see no key visit every tile while one warpgroup skips most of them.
    ("causal_sq1024_sk512_bf16", 1, 2, 1024, 512, 128, True, torch.bfloat16, BF16_TOL),
    ("causal_sq600_sk300_bf16", 1, 2, 600, 300, 128, True, torch.bfloat16, BF16_TOL),
    # batch * heads past 65535, the largest grid y: the grid is 1-D. One
    # query over 16 keys keeps |O| under 4, where a bf16 ulp is under 3e-2.
    ("heads65537_sq1_sk16_bf16", 1, 65537, 1, 16, 128, True, torch.bfloat16, BF16_TOL),
]
FLASH_TIMED = "serve_b8_h32_s512_d128_bf16"
FLASH_TRAIN = "train_b12_h32_s1024_d128_bf16"
# (name, x shape, dtype, offset, tol): any row count, an input whose data
# starts 4 bytes past an aligned address (the wrapper copies it to an
# aligned one), and every shape the main paths give the kernels: decode's
# [4, 1, 4096], generate's forward, the serve buckets and the train step's
# [12, 1024, 4096]. The forward's f32 is held by its absolute error, bf16
# in ulps; the backward by RMSNORM_BWD_*. The plain versions' and the
# library's times are taken at RMSNORM_TIMED (forward) and RMSNORM_TRAIN.
RMSNORM_CHECKS = [
    ("rows512_d512_f32", (4 * 128, 512), torch.float32, 0, RMSNORM_F32_TOL),
    ("odd_rows7_d512_f32", (7, 512), torch.float32, 0, RMSNORM_F32_TOL),
    ("unaligned_rows7_d512_f32", (7, 512), torch.float32, 1, RMSNORM_F32_TOL),
    ("decode_b4_s1_d4096_bf16", (GEN_BATCH, 1, 4096), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("gen_b4_s32_d4096_bf16", (GEN_BATCH, GEN_PROMPT, 4096), torch.bfloat16, 0,
     RMSNORM_BF16_ULPS),
    ("serve_b1_s512_d4096_bf16", (1, SERVE_SEQ, 4096), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("serve_b4_s512_d4096_bf16", (4, SERVE_SEQ, 4096), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("serve_b8_s512_d4096_bf16", (8, SERVE_SEQ, 4096), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("train_b12_s1024_d4096_bf16", (12, 1024, 4096), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    # The other routes through the kernels: a dim of one 16-byte piece, one
    # warp a row, 2 and 8 warps a row (at 6144 with pieces past the row's
    # end), f32 at the model's width, and rows too wide for registers (the
    # looped routes, past dim 8192 in bf16 and 4096 in f32).
    ("d8_rows9_bf16", (9, 8), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("d512_rows33_bf16", (33, 512), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("d2048_rows33_bf16", (33, 2048), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("d6144_rows5_bf16", (5, 6144), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("d4096_rows300_f32", (300, 4096), torch.float32, 0, RMSNORM_F32_TOL),
    ("d16384_rows3_bf16", (3, 16384), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("d40960_rows3_bf16", (3, 40960), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("d20480_rows3_f32", (3, 20480), torch.float32, 0, RMSNORM_F32_TOL),
]
RMSNORM_TIMED = "serve_b8_s512_d4096_bf16"
RMSNORM_TRAIN = "train_b12_s1024_d4096_bf16"
# Parts of the mangled names of the kernels each entry's timed shape
# launches (bf16; RMSNorm at dim 4096: four warps a row, four 16-byte
# pieces a lane, in both directions, then the dw sum).
PTXAS_NAMES = {
    "flash_attention_fwd": ("flash_fwd_wgmma",),
    "flash_attention_bwd_dq": ("flash_bwd_dq_wgmma",),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_wgmma",),
    "rmsnorm": ("rmsnorm_fwd_kernelI13__nv_bfloat16Li4ELi4E",),
    "rmsnorm_bwd": ("rmsnorm_bwd_kernelI13__nv_bfloat16Li4ELi4E",
                    "rmsnorm_dw_kernelI13__nv_bfloat16E"),
}


# (name, batch, heads, seq_q, seq_k, head_dim, causal, dtype, tol, unit):
# tests/test_ops.py's backward shapes, bf16, ragged lengths no tile divides,
# f32 at head_dim 128 (the largest shared-memory tile), more queries than
# keys (rows that see no key), and the shape the train path gives the
# kernels. Times are taken at BWD_TIMED.
BWD_CHECKS = [
    ("s256_d64_causal", 2, 4, 256, 256, 64, True, torch.float32, BWD_F32_TOL, "abs"),
    ("s256_d64_full", 2, 4, 256, 256, 64, False, torch.float32, BWD_F32_TOL, "abs"),
    ("s128_d32", 1, 2, 128, 128, 32, True, torch.float32, BWD_F32_TOL, "abs"),
    ("sq64_sk128", 1, 2, 64, 128, 32, True, torch.float32, BWD_F32_TOL, "abs"),
    ("bf16_s128_d64", 1, 2, 128, 128, 64, True, torch.bfloat16, BWD_BF16_TOL, "abs"),
    ("ragged_s100_d64", 1, 3, 100, 100, 64, True, torch.float32, BWD_F32_TOL, "abs"),
    ("f32_s192_d128", 1, 2, 192, 192, 128, True, torch.float32, BWD_F32_TOL, "abs"),
    ("causal_sq130_sk70", 1, 2, 130, 70, 64, True, torch.float32, BWD_F32_TOL, "abs"),
    ("ragged_sq37_sk200_bf16", 2, 2, 37, 200, 128, False, torch.bfloat16, BWD_REL_TOL,
     "rel_to_max"),
    ("ragged_sq37_sk200_causal_bf16", 2, 2, 37, 200, 128, True, torch.bfloat16, BWD_REL_TOL,
     "rel_to_max"),
    ("train_b12_h32_s1024_d128_bf16", 12, 32, 1024, 1024, 128, True, torch.bfloat16,
     BWD_REL_TOL, "rel_to_max"),
    # The edges of the wgmma dK/dV route (bf16 at head_dim 128), as for the
    # forward; seq_q > seq_k over several key tiles makes a warpgroup skip
    # runs of q tiles.
    ("causal_sq130_sk70_bf16", 1, 2, 130, 70, 128, True, torch.bfloat16, BWD_REL_TOL,
     "rel_to_max"),
    ("s200_causal_bf16", 1, 2, 200, 200, 128, True, torch.bfloat16, BWD_REL_TOL, "rel_to_max"),
    ("s200_full_bf16", 1, 2, 200, 200, 128, False, torch.bfloat16, BWD_REL_TOL, "rel_to_max"),
    ("s1000_causal_bf16", 1, 4, 1000, 1000, 128, True, torch.bfloat16, BWD_REL_TOL,
     "rel_to_max"),
    ("causal_sq1024_sk512_bf16", 1, 2, 1024, 512, 128, True, torch.bfloat16, BWD_REL_TOL,
     "rel_to_max"),
    ("causal_sq600_sk300_bf16", 1, 2, 600, 300, 128, True, torch.bfloat16, BWD_REL_TOL,
     "rel_to_max"),
    ("heads65537_sq1_sk16_bf16", 1, 65537, 1, 16, 128, True, torch.bfloat16, BWD_REL_TOL,
     "rel_to_max"),
]
BWD_TIMED = "train_b12_h32_s1024_d128_bf16"


def _flash_bound(b, h, sq, sk, d, causal, dtype) -> tuple[float, str]:
    ops = 4 * b * h * d * _causal_pairs(sq, sk, causal)  # QK^T and PV, 2 per multiply-add
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * size + b * h * sq * 4  # q k v o, LSE
    return bound(ops, nbytes, dtype)


def _bwd_bounds(b, h, sq, sk, d, causal, dtype) -> dict:
    """Bounds of the dQ kernel (QK^T, dO V^T, dS K; reads q k v O dO LSE,
    writes dQ and delta) and of the dK/dV kernel (K Q^T, V dO^T, P^T dO,
    dS^T Q; reads q k v dO LSE delta, writes dK dV): 2 * d operations per
    product and visible pair."""
    pairs = b * h * _causal_pairs(sq, sk, causal)
    size = torch.tensor([], dtype=dtype).element_size()
    rows_f32 = 2 * b * h * sq * 4
    return {
        "dq": bound(3 * 2 * d * pairs, (4 * sq + 2 * sk) * b * h * d * size + rows_f32, dtype),
        "dkv": bound(4 * 2 * d * pairs, (2 * sq + 4 * sk) * b * h * d * size + rows_f32, dtype),
    }


def _bwd_err(out: torch.Tensor, plain: torch.Tensor, unit: str) -> float:
    err = max_err(out, plain)
    return err / float(plain.float().abs().max()) if unit == "rel_to_max" else err


def _bwd_entries(gen) -> list[dict]:
    """The dQ and dK/dV kernels against _flash_backward_reference."""
    checks = []
    for name, b, h, sq, sk, d, causal, dtype, tol, unit in BWD_CHECKS:
        q = _randn(gen, (b, h, sq, d), dtype)
        k = _randn(gen, (b, h, sk, d), dtype)
        v = _randn(gen, (b, h, sk, d), dtype)
        do = _randn(gen, (b, h, sq, d), dtype)
        out, lse = flash_mod._flash_forward(q, k, v, causal=causal)
        (dq, dk, dv), route = _reported_route(
            (flash_mod._flash_bwd_dq, flash_mod._flash_bwd_dkv),
            lambda: flash_mod._flash_backward(q, k, v, out, lse, do, causal=causal),
            dtype, d, f"flash bwd {name}",
        )
        torch.cuda.synchronize()
        plain = flash_mod._flash_backward_reference(q, k, v, out, lse, do, causal=causal)
        for got, want, which in zip((dq, dk, dv), plain, ("dq", "dk", "dv")):
            require(got.dtype == want.dtype and got.shape == want.shape,
                    f"flash bwd {name}: {which} shape/dtype")
        errs = [_bwd_err(got, want, unit) for got, want in zip((dq, dk, dv), plain)]
        abs_errs = [max_err(got, want) for got, want in zip((dq, dk, dv), plain)]
        check = dict(shape=name, route=route, unit=unit, tol=tol,
                     dq_err=errs[0], dk_err=errs[1], dv_err=errs[2], dq_abs=abs_errs[0],
                     dkv_abs=max(abs_errs[1:]))
        checks.append(check)
        require(max(errs) < tol, f"flash bwd {name}: dq/dk/dv vs plain {errs} ({unit}) >= {tol}")
        if name == BWD_TIMED:
            inputs = (q, k, v, out, lse, do, dq, dk, dv)
        del out, lse, dq, dk, dv, plain
    q, k, v, out, lse, do, dq, dk, dv = inputs
    timed = checks[[c["shape"] for c in checks].index(BWD_TIMED)]
    scale = q.shape[-1] ** -0.5
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
    dq_t = time_ms(lambda: flash_mod._flash_bwd_dq(q, k, v, out, do, lse, delta, dq, True, scale))
    dkv_t = time_ms(
        lambda: flash_mod._flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, True, scale)
    )
    plain_ms = time_ms(
        lambda: flash_mod._flash_backward_reference(q, k, v, out, lse, do, causal=True), iters=5
    )["ms"]
    by_backend = _sdpa_backward_times(q, k, v, do)
    backend = min((b for b, t in by_backend.items() if "ms" in t),
                  key=lambda b: by_backend[b]["ms"], default=None)
    require(backend is not None, f"flash bwd: no SDPA backend ran its backward: {by_backend}")
    bounds = _bwd_bounds(*q.shape[:3], k.shape[2], q.shape[3], True, q.dtype)
    common = dict(
        route="cuda", launches=None, kernel_route=timed["route"],
        unit=timed["unit"], tol=timed["tol"], plain_ms=plain_ms,
        plain="_flash_backward_reference (dQ, dK and dV together)",
        library_ms=by_backend[backend]["ms"], library_ms_range=by_backend[backend]["range"],
        library=("torch.autograd.grad through F.scaled_dot_product_attention (dQ, dK and dV), "
                 f"the fastest backend: {backend}"),
        library_by_backend=by_backend, shape=BWD_TIMED, checks=checks,
    )
    return [
        dict(name="flash_attention_bwd_dq", replaces="ray_tpu/ops/flash_attention.py:125",
             source="ray_tpu_torch/ops/csrc/flash_bwd_dq_wgmma.cu",
             max_abs_err=timed["dq_abs"], err=timed["dq_err"], ms=dq_t["ms"],
             ms_range=dq_t["range"], bound_ms=bounds["dq"][0], bound_by=bounds["dq"][1],
             **common),
        dict(name="flash_attention_bwd_dkv", replaces="ray_tpu/ops/flash_attention.py:167",
             source="ray_tpu_torch/ops/csrc/flash_bwd_dkv_wgmma.cu",
             max_abs_err=timed["dkv_abs"], err=max(timed["dk_err"], timed["dv_err"]),
             ms=dkv_t["ms"], ms_range=dkv_t["range"], bound_ms=bounds["dkv"][0],
             bound_by=bounds["dkv"][1], **common),
    ]


def _sdpa_backward_times(q, k, v, do, label: str = BWD_TIMED) -> dict:
    """SDPA's backward (dQ, dK and dV) under each backend, timed alone at
    these inputs; a backend that cannot run them reports its error. The
    port never calls SDPA: this is the yardstick."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        try:
            with sdpa_kernel(backend):
                lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
                times[name.lower()] = time_ms(
                    lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)
                )
        except RuntimeError as err:
            times[name.lower()] = {"error": str(err)[:200]}
        lib_out = None  # frees this backend's graph before the next one's forward
    log("sdpa_backward", shape=label, by_backend=times)
    return times


def _rmsnorm_bound(rows, dim, dtype, wdtype=None) -> tuple[float, str]:
    ops = 4 * rows * dim  # square-add, and two multiplies per element (f32)
    return bound(ops, 2 * rows * dim * _size(dtype) + dim * _size(wdtype or dtype),
                 torch.float32)


def _rmsnorm_bwd_bound(rows, dim, dtype, wdtype=None) -> tuple[float, str]:
    """Reads x, dy and w, writes dx and dw; about 10 f32 operations per
    element (two square-adds, n, dy * n into dw, and dx's four). The
    kernel's per-block dw sums are its own traffic, not the function's."""
    nbytes = 3 * rows * dim * _size(dtype) + 2 * dim * _size(wdtype or dtype)
    return bound(10 * rows * dim, nbytes, torch.float32)


def _size(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def _ulp(value: float, bits: int) -> float:
    """One ulp at |value| with `bits` significand bits: 2^(e - bits) for
    |value| in [2^(e-1), 2^e)."""
    return math.ldexp(1.0, math.frexp(abs(value))[1] - bits) if value else 2.0 ** -133


def _rmsnorm_bwd_err(out: torch.Tensor, plain: torch.Tensor) -> float:
    """max |out - plain| in ulps of plain's largest magnitude (bf16, f16),
    or over that magnitude (f32)."""
    top = float(plain.float().abs().max())
    err = max_err(out, plain)
    if plain.dtype in SIGNIFICAND_BITS:
        return err / _ulp(top, SIGNIFICAND_BITS[plain.dtype])
    return err / top if top else err


def _rows_input(gen, shape, dtype, offset: int) -> torch.Tensor:
    """A [..., dim] input whose data starts `offset` elements past the
    allocation (4 bytes past an aligned address for offset 1 in f32)."""
    n = int(np.prod(shape))
    return _randn(gen, (offset + n,), dtype)[offset:].view(shape)


def _library_rmsnorm_backward(x, w, dy) -> tuple:
    """One PyTorch call that computes the norm's dx and dw from x, w and dy:
    aten's fused RMSNorm backward given its forward's rstd where this torch
    has it, else autograd through F.rms_norm. The port never calls it."""
    dim = x.shape[-1]
    aten = torch.ops.aten
    if hasattr(aten, "_fused_rms_norm") and hasattr(aten, "_fused_rms_norm_backward"):
        try:
            _, rstd = aten._fused_rms_norm(x, [dim], w, 1e-6)
            aten._fused_rms_norm_backward(dy, x, [dim], rstd, w, [True, True])
            return (lambda: aten._fused_rms_norm_backward(dy, x, [dim], rstd, w, [True, True]),
                    "torch.ops.aten._fused_rms_norm_backward, given _fused_rms_norm's rstd")
        except (NotImplementedError, RuntimeError) as err:  # no kernel for this device
            log("rmsnorm_library", fused_backward_error=str(err)[:200])
    xl, wl = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    out = F.rms_norm(xl, (dim,), wl, eps=1e-6)
    return (lambda: torch.autograd.grad(out, (xl, wl), dy, retain_graph=True),
            "torch.autograd.grad through F.rms_norm")


def host_us(fn, calls: int = 2000) -> float:
    """Host microseconds per call of fn: the wall time of `calls` calls and
    one synchronize, after a warm-up. Meant for shapes whose kernels take a
    few microseconds, where the host's issue rate is what the card waits on."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / calls * 1e6


def rmsnorm_forward_path() -> dict:
    """The RMSNorm forward through the package's public ``rmsnorm``, beside
    F.rms_norm: host microseconds a call at decode's [4, 4096] bf16 (65
    calls a decode step) with autograd off, as serving and decode call it,
    and with a weight that requires a gradient, as training does; and the
    device time a call at the serving and train shapes. Uses nothing but
    ``rmsnorm``, so it also measures another version of the package put
    first on the path."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    shapes = {"decode": (GEN_BATCH, 4096), "serve": (8 * SERVE_SEQ, 4096),
              "train": (TRAIN_BATCH * 1024, 4096)}
    x, w = {}, _randn(gen, (4096,), torch.bfloat16)
    for name, shape in shapes.items():
        x[name] = _randn(gen, shape, torch.bfloat16)
    trained = w.detach().requires_grad_(True)
    result = dict(package=str(Path(rmsnorm_mod.__file__).parents[2]))
    with torch.no_grad():
        result["host_us_no_grad"] = host_us(lambda: rmsnorm_mod.rmsnorm(x["decode"], w))
        result["library_host_us"] = host_us(lambda: F.rms_norm(x["decode"], (4096,), w, eps=1e-6))
        for name in ("serve", "train"):
            result[f"{name}_device_ms"] = per_call_device_ms(
                lambda: rmsnorm_mod.rmsnorm(x[name], w))
            result[f"{name}_library_device_ms"] = per_call_device_ms(
                lambda: F.rms_norm(x[name], (4096,), w, eps=1e-6))
    result["host_us_grad"] = host_us(lambda: rmsnorm_mod.rmsnorm(x["decode"], trained))
    log("rmsnorm_forward_path", **result)
    return result


def _rmsnorm_entries(gen) -> list[dict]:
    """The RMSNorm forward and backward kernels against rmsnorm_reference
    and _rmsnorm_backward at every RMSNORM_CHECKS shape."""
    def library_fwd(x, w):
        return lambda: F.rms_norm(x, (x.shape[-1],), w, eps=1e-6)

    def fwd_times(x, w) -> dict:
        library = time_ms(library_fwd(x, w))
        return dict(
            plain_ms=time_ms(lambda: rmsnorm_mod.rmsnorm_reference(x, w))["ms"],
            library_ms=library["ms"], library_ms_range=library["range"],
            library_device_ms=per_call_device_ms(library_fwd(x, w)),
        )

    fwd_checks, bwd_checks, kept = [], [], {}
    for name, shape, dtype, offset, tol in RMSNORM_CHECKS:
        rows, dim = int(np.prod(shape[:-1])), shape[-1]
        x = _rows_input(gen, shape, dtype, offset)
        w = _randn(gen, (dim,), dtype)
        dy = _rows_input(gen, shape, dtype, offset)
        y = rmsnorm_mod.rmsnorm(x, w)
        torch.cuda.synchronize()
        plain = rmsnorm_mod.rmsnorm_reference(x, w)
        if dtype == torch.bfloat16:
            err, unit = ulps(y, plain), "bf16_ulps"
        else:
            err, unit = max_err(y, plain), "abs"
        kernel = time_ms(lambda: rmsnorm_mod.rmsnorm(x, w))
        fwd_checks.append(dict(
            shape=name, max_abs_err=max_err(y, plain), err=err, unit=unit, tol=tol,
            kernel_ms=kernel["ms"], kernel_ms_range=kernel["range"],
            kernel_device_ms=per_call_device_ms(lambda: rmsnorm_mod.rmsnorm(x, w)),
            bound_ms=_rmsnorm_bound(rows, dim, dtype)[0],
        ))
        require(y.dtype == dtype and y.shape == x.shape, f"rmsnorm {name}: output shape/dtype")
        require(err <= tol, f"rmsnorm {name}: y vs plain {err} {unit} > {tol}")

        dx, dw = rmsnorm_mod.rmsnorm_backward(x, w, dy)
        again = rmsnorm_mod.rmsnorm_backward(x, w, dy)
        torch.cuda.synchronize()
        pdx, pdw = rmsnorm_mod._rmsnorm_backward(x, w, dy, 1e-6)
        bwd_tol = RMSNORM_BWD_BF16_TOL if dtype == torch.bfloat16 else RMSNORM_BWD_F32_TOL
        dx_err, dw_err = _rmsnorm_bwd_err(dx, pdx), _rmsnorm_bwd_err(dw, pdw)
        bwd_checks.append(dict(
            shape=name, unit="bf16_ulps_of_max" if dtype == torch.bfloat16 else "rel_to_max",
            tol=bwd_tol, dx_err=dx_err, dw_err=dw_err, dx_abs=max_err(dx, pdx),
            dw_abs=max_err(dw, pdw), bound_ms=_rmsnorm_bwd_bound(rows, dim, dtype)[0],
        ))
        require(dx.dtype == dtype and dx.shape == x.shape and dw.dtype == dtype
                and dw.shape == w.shape, f"rmsnorm bwd {name}: output shape/dtype")
        require(max(dx_err, dw_err) <= bwd_tol,
                f"rmsnorm bwd {name}: dx, dw vs plain {dx_err}, {dw_err} > {bwd_tol}")
        require(torch.equal(dx, again[0]) and torch.equal(dw, again[1]),
                f"rmsnorm bwd {name}: two calls on the same inputs differ")
        if name in (RMSNORM_TIMED, RMSNORM_TRAIN):
            kept[name] = (fwd_checks[-1], bwd_checks[-1], (x, w, dy))
        del y, plain, dx, dw, again, pdx, pdw

    timed, _, (x, w, _) = kept[RMSNORM_TIMED]
    train, train_bwd, (tx, tw, tdy) = kept[RMSNORM_TRAIN]
    dim = x.shape[-1]
    bound_ms, bound_by = _rmsnorm_bound(x.numel() // dim, dim, x.dtype)
    forward = dict(
        name="rmsnorm", route="cuda", source="ray_tpu_torch/ops/csrc/rmsnorm.cu",
        replaces="ray_tpu/ops/rmsnorm.py:17",
        launches=None, max_abs_err=timed["max_abs_err"], err=timed["err"], unit=timed["unit"],
        tol=timed["tol"], ms=timed["kernel_ms"], ms_range=timed["kernel_ms_range"],
        device_ms=timed["kernel_device_ms"], **fwd_times(x, w),
        bound_ms=bound_ms, bound_by=bound_by,
        library="torch.nn.functional.rms_norm", forward_path=rmsnorm_forward_path(),
        shape=RMSNORM_TIMED, checks=fwd_checks,
        at_train_shape=dict(shape=RMSNORM_TRAIN, ms=train["kernel_ms"],
                            ms_range=train["kernel_ms_range"],
                            device_ms=train["kernel_device_ms"], bound_ms=train["bound_ms"],
                            **fwd_times(tx, tw)),
    )

    kernel = time_ms(lambda: rmsnorm_mod.rmsnorm_backward(tx, tw, tdy))
    library_call, library_name = _library_rmsnorm_backward(tx, tw, tdy)
    library_dx, library_dw = library_call()[:2]
    pdx, pdw = rmsnorm_mod._rmsnorm_backward(tx, tw, tdy, 1e-6)
    library = time_ms(library_call)
    bound_ms, bound_by = _rmsnorm_bwd_bound(tx.numel() // dim, dim, tx.dtype)
    backward = dict(
        name="rmsnorm_bwd", route="cuda", source="ray_tpu_torch/ops/csrc/rmsnorm.cu",
        replaces="ray_tpu/ops/rmsnorm.py:17",
        replaces_note=("the backward of _rmsnorm_kernel's function, which the JAX model "
                       "leaves to XLA's fusion of jax.checkpoint(rmsnorm_reference) "
                       "(ray_tpu/models/transformer.py:229)"),
        launches=None, max_abs_err=max(train_bwd["dx_abs"], train_bwd["dw_abs"]),
        err=max(train_bwd["dx_err"], train_bwd["dw_err"]), unit=train_bwd["unit"],
        tol=train_bwd["tol"], ms=kernel["ms"], ms_range=kernel["range"],
        device_ms=per_call_device_ms(lambda: rmsnorm_mod.rmsnorm_backward(tx, tw, tdy)),
        plain_ms=time_ms(lambda: rmsnorm_mod._rmsnorm_backward(tx, tw, tdy, 1e-6), iters=5)["ms"],
        plain="_rmsnorm_backward",
        library_ms=library["ms"], library_ms_range=library["range"],
        library_device_ms=per_call_device_ms(library_call), library=library_name,
        library_err=[_rmsnorm_bwd_err(library_dx, pdx), _rmsnorm_bwd_err(library_dw, pdw)],
        bound_ms=bound_ms, bound_by=bound_by, shape=RMSNORM_TRAIN, checks=bwd_checks,
    )
    return [forward, backward]


# ---------------------------------------------------------------- other inputs
# The kernels' instantiations for the inputs the reference takes beyond the
# model's bf16 at head_dim 128 and dim 4096: TransformerConfig.tiny()'s
# head_dim 16 (the tiny path runs it in f32) in f32, bf16 and f16; f16 at
# head_dim 64 and 128; a head_dim no kernel is built for (80, zero-padded to
# 128); and RMSNorm at tiny's dim 64, at a dim of no whole 16-byte pieces
# (50), in f16, and with bf16 x and an f32 weight. Each is held against its
# plain version, forward and backward, at its timed shape and at the edge
# shapes beside it, and timed at the timed shape.
TINY_BATCH, TINY_SEQ = 2, 64
# (label, dtype, head_dim, timed (batch, heads, seq), edge shapes (batch,
# heads, seq_q, seq_k, causal)). The timed shape is causal with seq_q ==
# seq_k, where SDPA's causal mask agrees.
FLASH_INSTANTIATIONS = [
    ("d16_f32", torch.float32, 16, (TINY_BATCH, 4, TINY_SEQ),
     [(1, 3, 100, 160, True), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d16_bf16", torch.bfloat16, 16, (TINY_BATCH, 4, TINY_SEQ),
     [(1, 3, 100, 160, True), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d16_f16", torch.float16, 16, (TINY_BATCH, 4, TINY_SEQ),
     [(1, 3, 100, 160, True), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d64_f16", torch.float16, 64, (4, 32, SERVE_SEQ),
     [(2, 4, 256, 256, False), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    # BERT-base's heads (phase 23): bf16 at 64 on the mma.sync route, timed
    # at the largest bucket the serving path gives it.
    ("d64_bf16", torch.bfloat16, 64, (8, 12, 32),
     [(2, 4, 256, 256, False), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d128_f16", torch.float16, 128, (4, 32, SERVE_SEQ),
     [(1, 2, 192, 192, True), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d80_bf16_padded", torch.bfloat16, 80, (4, 32, SERVE_SEQ),
     [(1, 3, 100, 160, True), (1, 3, 100, 160, False), (1, 2, 130, 70, True)]),
    # Gemma's head_dim: each block computes half of the output's columns;
    # f32 blocks have two warps, so the edge shapes include a ragged tile
    # of 32 rows.
    ("d256_f32", torch.float32, 256, (4, 32, SERVE_SEQ),
     [(1, 2, 192, 192, True), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d256_bf16", torch.bfloat16, 256, (4, 32, SERVE_SEQ),
     [(1, 2, 192, 192, True), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d256_f16", torch.float16, 256, (4, 32, SERVE_SEQ),
     [(1, 2, 192, 192, True), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d192_bf16_padded", torch.bfloat16, 192, (4, 32, SERVE_SEQ),
     [(1, 3, 100, 160, True), (1, 3, 100, 160, False), (1, 2, 130, 70, True)]),
    # Above 256 (flash_attention_wide.cu): a block per 128-column slice of
    # the output, the scores summed over 128-column chunks of the head. The
    # f32 FMA kernels are timed at one batch row.
    ("d512_f32", torch.float32, 512, (1, 32, SERVE_SEQ),
     [(1, 2, 192, 192, True), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d512_bf16", torch.bfloat16, 512, (4, 32, SERVE_SEQ),
     [(1, 2, 192, 192, True), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d512_f16", torch.float16, 512, (4, 32, SERVE_SEQ),
     [(1, 2, 192, 192, True), (1, 2, 130, 70, True), (2, 2, 37, 200, False)]),
    ("d320_bf16_padded", torch.bfloat16, 320, (4, 32, SERVE_SEQ),
     [(1, 3, 100, 160, True), (1, 3, 100, 160, False), (1, 2, 130, 70, True)]),
]
# (label, timed x shape, x dtype, weight dtype, edge x shapes).
RMSNORM_INSTANTIATIONS = [
    ("d64_f32", (TINY_BATCH, TINY_SEQ, 64), torch.float32, torch.float32, [(9, 64)]),
    ("d50_bf16", (8 * SERVE_SEQ, 50), torch.bfloat16, torch.bfloat16, [(9, 50), (3, 7, 50)]),
    ("d4096_f16", (8, SERVE_SEQ, 4096), torch.float16, torch.float16, [(9, 4096), (33, 512)]),
    ("bf16_x_f32_w", (8, SERVE_SEQ, 4096), torch.bfloat16, torch.float32, [(9, 50), (33, 512)]),
    # BERT-base's width (phase 23), at the largest bucket: the vector route.
    ("d768_bf16", (8, 32, 768), torch.bfloat16, torch.bfloat16, [(9, 768), (33, 768)]),
]
# The instantiations a main path runs, and the paths: every launch on the
# tiny path is of its two, every launch on the BERT-base serving paths (the
# HTTP path of phase 23, the multiplexed and chaos paths of phase 27) of
# their two.
SERVE_REPLICA_PATHS = ("serve_http", "serve_mux", "serve_chaos")
INSTANTIATION_PATHS = {"d16_f32": ("tiny",), "d64_f32": ("tiny",),
                       "d64_bf16": SERVE_REPLICA_PATHS, "d768_bf16": SERVE_REPLICA_PATHS}
FORWARD_ONLY_PATHS = SERVE_REPLICA_PATHS


def _flash_sources(route: str, size: int = 128) -> dict:
    if route == "wgmma":
        return {"fwd": "flash_fwd_wgmma.cu", "dq": "flash_bwd_dq_wgmma.cu",
                "dkv": "flash_bwd_dkv_wgmma.cu"}
    if size > 256:
        return dict.fromkeys(("fwd", "dq", "dkv"), "flash_attention_wide.cu")
    return {"fwd": "flash_attention_fwd.cu", "dq": "flash_attention_bwd.cu",
            "dkv": "flash_attention_bwd.cu"}


def _mangled(dtype) -> str:
    return {torch.float32: "f", torch.bfloat16: "13__nv_bfloat16", torch.float16: "6__half"}[dtype]


def _flash_check(gen, b, h, sq, sk, d, causal, dtype, what: str) -> dict:
    """One shape through the forward and both backward kernels against the
    plain versions; returns the errors and the tensors."""
    q, k, v, do = (_randn(gen, (b, h, n, d), dtype) for n in (sq, sk, sk, sq))
    (out, lse), route = _reported_route(
        (flash_mod.flash_attention,), lambda: flash_mod._flash_forward(q, k, v, causal=causal),
        dtype, d, f"{what} fwd")
    grads, _ = _reported_route(
        (flash_mod._flash_bwd_dq, flash_mod._flash_bwd_dkv),
        lambda: flash_mod._flash_backward(q, k, v, out, lse, do, causal=causal),
        dtype, d, f"{what} bwd")
    torch.cuda.synchronize()
    ref = flash_mod.attention_reference(q, k, v, causal=causal)
    lse_ref = flash_mod._lse_reference(q, k, causal=causal, scale=d ** -0.5)
    plain = flash_mod._flash_backward_reference(q, k, v, out, lse, do, causal=causal)
    require(out.shape == q.shape and out.dtype == dtype, f"{what}: O shape/dtype")
    for got, want in zip(grads, plain):
        require(got.shape == want.shape and got.dtype == want.dtype, f"{what}: grad shape/dtype")
    unit = "abs" if dtype == torch.float32 else "rel_to_max"
    check = dict(shape=[b, h, sq, sk, d], causal=causal, route=route,
                 max_abs_err=max_err(out, ref), lse_err=max_err(lse, lse_ref), unit=unit,
                 dq_err=_bwd_err(grads[0], plain[0], unit),
                 dkv_err=max(_bwd_err(g, p, unit) for g, p in zip(grads[1:], plain[1:])),
                 dq_abs=max_err(grads[0], plain[0]),
                 dkv_abs=max(max_err(g, p) for g, p in zip(grads[1:], plain[1:])))
    fwd_tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    bwd_tol = BWD_F32_TOL if dtype == torch.float32 else BWD_REL_TOL
    require(check["max_abs_err"] < fwd_tol, f"{what}: max |O - plain| {check['max_abs_err']}")
    require(check["lse_err"] < LSE_TOL[dtype], f"{what}: max |LSE - plain| {check['lse_err']}")
    require(max(check["dq_err"], check["dkv_err"]) < bwd_tol,
            f"{what}: dq, dk/dv vs plain {check['dq_err']}, {check['dkv_err']} ({unit})")
    check.update(fwd_tol=fwd_tol, bwd_tol=bwd_tol)
    return check, (q, k, v, do, out, lse)


def _flash_instantiation_entries(gen) -> list[dict]:
    """Forward, dQ and dK/dV entries for each of FLASH_INSTANTIATIONS."""
    entries = []
    for label, dtype, d, (b, h, s), edges in FLASH_INSTANTIATIONS:
        checks = []
        for eb, eh, sq, sk, causal in edges:
            checks.append(_flash_check(gen, eb, eh, sq, sk, d, causal, dtype,
                                       f"flash {label} {[eb, eh, sq, sk]}")[0])
        timed, (q, k, v, do, out, lse) = _flash_check(gen, b, h, s, s, d, True, dtype,
                                                      f"flash {label} timed")
        checks.append(timed)
        route = timed["route"]
        size = flash_mod.padded_head_dim(d)
        scale = d ** -0.5
        # The backward kernels as the wrapper launches them: on inputs
        # padded to the built head_dim.
        qp, kp, vp, outp, dop = (flash_mod._pad_head(t, size).contiguous()
                                 for t in (q, k, v, out, do))
        dq, dk, dv = (torch.empty_like(t) for t in (qp, kp, vp))
        delta = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
        calls = {
            "fwd": lambda: flash_mod.flash_attention(q, k, v, causal=True),
            "dq": lambda: flash_mod._flash_bwd_dq(qp, kp, vp, outp, dop, lse, delta, dq, True,
                                                  scale),
            "dkv": lambda: flash_mod._flash_bwd_dkv(qp, kp, vp, dop, lse, delta, dk, dv, True,
                                                    scale),
        }
        fwd_t, dq_t, dkv_t = (time_ms(call) for call in calls.values())
        # torch.profiler's device time a call: the events windows of these
        # small shapes can time the host path instead.
        device = {part: per_call_device_ms(call) for part, call in calls.items()}
        plain_fwd = time_ms(lambda: flash_mod.attention_reference(q, k, v, causal=True))["ms"]
        plain_bwd = time_ms(lambda: flash_mod._flash_backward_reference(
            q, k, v, out, lse, do, causal=True), iters=5)["ms"]
        library = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        by_backend = _sdpa_backward_times(q, k, v, do, label=f"{label} {[b, h, s, s, d]}")
        backend = min((n for n, t in by_backend.items() if "ms" in t),
                      key=lambda n: by_backend[n]["ms"], default=None)
        fwd_bound = _flash_bound(b, h, s, s, d, True, dtype)
        bwd_bounds = _bwd_bounds(b, h, s, s, d, True, dtype)
        sources = _flash_sources(route, size)
        common = dict(route="cuda", kernel_route=route, launches=None, shape=[b, h, s, s, d],
                      instantiation=label, on_main_path=label in INSTANTIATION_PATHS, checks=checks)
        bwd_library = dict(
            library_ms=by_backend[backend]["ms"] if backend else None,
            library_ms_range=by_backend[backend]["range"] if backend else None,
            library=(f"torch.autograd.grad through F.scaled_dot_product_attention, the "
                     f"fastest backend: {backend}"), library_by_backend=by_backend,
            plain_ms=plain_bwd, plain="_flash_backward_reference (dQ, dK and dV together)")
        kernel = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}
        ptxas = {part: ((f"{kernel[part]}_wgmma",) if route == "wgmma" else
                        (f"{kernel[part]}_wide_kernelI{_mangled(dtype)}E",) if size > 256 else
                        (f"{kernel[part]}_kernelI{_mangled(dtype)}Li{size}E",))
                 for part in kernel}
        entries.append(dict(
            name=f"flash_attention_fwd[{label}]",
            source=f"ray_tpu_torch/ops/csrc/{sources['fwd']}",
            replaces="ray_tpu/ops/flash_attention.py:79", max_abs_err=timed["max_abs_err"],
            err=timed["max_abs_err"], unit="abs", tol=timed["fwd_tol"], ms=fwd_t["ms"],
            ms_range=fwd_t["range"], plain_ms=plain_fwd, library_ms=library["ms"],
            library_ms_range=library["range"],
            library="torch.nn.functional.scaled_dot_product_attention",
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1], device_ms=device["fwd"],
            ptxas_names=ptxas["fwd"], **common))
        entries.append(dict(
            name=f"flash_attention_bwd_dq[{label}]",
            source=f"ray_tpu_torch/ops/csrc/{sources['dq']}",
            replaces="ray_tpu/ops/flash_attention.py:125", max_abs_err=timed["dq_abs"],
            err=timed["dq_err"], unit=timed["unit"], tol=timed["bwd_tol"], ms=dq_t["ms"],
            ms_range=dq_t["range"], bound_ms=bwd_bounds["dq"][0],
            bound_by=bwd_bounds["dq"][1], device_ms=device["dq"], ptxas_names=ptxas["dq"],
            **bwd_library, **common))
        entries.append(dict(
            name=f"flash_attention_bwd_dkv[{label}]",
            source=f"ray_tpu_torch/ops/csrc/{sources['dkv']}",
            replaces="ray_tpu/ops/flash_attention.py:167", max_abs_err=timed["dkv_abs"],
            err=timed["dkv_err"], unit=timed["unit"], tol=timed["bwd_tol"], ms=dkv_t["ms"],
            ms_range=dkv_t["range"], bound_ms=bwd_bounds["dkv"][0],
            bound_by=bwd_bounds["dkv"][1], device_ms=device["dkv"], ptxas_names=ptxas["dkv"],
            **bwd_library, **common))
        for entry in entries[-3:]:
            _log_kernel(entry)
        del q, k, v, do, out, lse, qp, kp, vp, outp, dop, dq, dk, dv
    return entries


def _rmsnorm_check(gen, shape, dtype, wdtype, what: str) -> tuple[dict, tuple]:
    """One shape through the RMSNorm forward and backward kernels against
    the plain versions, with the backward run twice (dw's fixed order)."""
    x, dy = _randn(gen, shape, dtype), _randn(gen, shape, dtype)
    w = _randn(gen, shape[-1:], wdtype)
    y = rmsnorm_mod.rmsnorm(x, w)
    dx, dw = rmsnorm_mod.rmsnorm_backward(x, w, dy)
    again = rmsnorm_mod.rmsnorm_backward(x, w, dy)
    torch.cuda.synchronize()
    plain = rmsnorm_mod.rmsnorm_reference(x, w)
    pdx, pdw = rmsnorm_mod._rmsnorm_backward(x, w, dy, 1e-6)
    require(y.dtype == dtype and dx.dtype == dtype and dw.dtype == wdtype
            and y.shape == x.shape and dx.shape == x.shape and dw.shape == w.shape,
            f"{what}: output shapes/dtypes")
    if dtype in SIGNIFICAND_BITS:
        err, unit, tol = ulps(y, plain), "ulps", RMSNORM_BF16_ULPS
    else:
        err, unit, tol = max_err(y, plain), "abs", RMSNORM_F32_TOL
    bwd = {}
    for name, got, want in (("dx", dx, pdx), ("dw", dw, pdw)):
        bound_ = RMSNORM_BWD_BF16_TOL if want.dtype in SIGNIFICAND_BITS else RMSNORM_BWD_F32_TOL
        bwd[name] = (_rmsnorm_bwd_err(got, want), bound_, max_err(got, want))
    check = dict(shape=list(shape), dtype=str(dtype), weight_dtype=str(wdtype),
                 max_abs_err=max_err(y, plain), err=err, unit=unit, tol=tol,
                 dx_err=bwd["dx"][0], dw_err=bwd["dw"][0], dx_abs=bwd["dx"][2],
                 dw_abs=bwd["dw"][2], bwd_tol=[bwd["dx"][1], bwd["dw"][1]],
                 bwd_unit="[dx, dw]: ulps of the largest magnitude (bf16, f16) or over it (f32)")
    require(err <= tol, f"{what}: y vs plain {err} {unit} > {tol}")
    for name, (e, bound_, _) in bwd.items():
        require(e <= bound_, f"{what}: {name} vs plain {e} > {bound_}")
    require(torch.equal(dx, again[0]) and torch.equal(dw, again[1]),
            f"{what}: two backward calls on the same inputs differ")
    return check, (x, w, dy)


def _library_time(make_call) -> tuple:
    """time_ms of the library call make_call() returns, or (None, reason)
    where this torch has no call for these inputs."""
    try:
        call, name = make_call()
        call()
        return time_ms(call), name
    except (RuntimeError, NotImplementedError, TypeError) as err:
        return None, f"no library call for these inputs: {str(err)[:160]}"


def _rmsnorm_instantiation_entries(gen) -> list[dict]:
    """Forward and backward entries for each of RMSNORM_INSTANTIATIONS."""
    entries = []
    for label, shape, dtype, wdtype, edges in RMSNORM_INSTANTIATIONS:
        checks = [_rmsnorm_check(gen, e, dtype, wdtype, f"rmsnorm {label} {list(e)}")[0]
                  for e in edges]
        timed, (x, w, dy) = _rmsnorm_check(gen, shape, dtype, wdtype, f"rmsnorm {label} timed")
        checks.append(timed)
        rows, dim = x.numel() // shape[-1], shape[-1]
        fwd_t = time_ms(lambda: rmsnorm_mod.rmsnorm(x, w))
        bwd_t = time_ms(lambda: rmsnorm_mod.rmsnorm_backward(x, w, dy))
        lib_fwd, lib_fwd_name = _library_time(lambda: (
            lambda: F.rms_norm(x, (dim,), w, eps=1e-6), "torch.nn.functional.rms_norm"))
        lib_bwd, lib_bwd_name = _library_time(lambda: _library_rmsnorm_backward(x, w, dy))
        fwd_bound = _rmsnorm_bound(rows, dim, dtype, wdtype)
        bwd_bound = _rmsnorm_bwd_bound(rows, dim, dtype, wdtype)
        scalar = dtype != wdtype or dim % (16 // _size(dtype)) != 0
        common = dict(route="cuda", source="ray_tpu_torch/ops/csrc/rmsnorm.cu",
                      replaces="ray_tpu/ops/rmsnorm.py:17", launches=None, shape=list(shape),
                      instantiation=label, kernel_route="scalar" if scalar else "vector",
                      on_main_path=label in INSTANTIATION_PATHS, checks=checks)
        fwd_name = "rmsnorm_fwd_scalar_kernelI" if scalar else (
            "rmsnorm_fwd_f16_kernel" if dtype == torch.float16 else "rmsnorm_fwd_kernelI")
        bwd_name = "rmsnorm_bwd_scalar_kernelI" if scalar else "rmsnorm_bwd_kernelI"
        entries.append(dict(
            name=f"rmsnorm[{label}]", max_abs_err=timed["max_abs_err"], err=timed["err"],
            unit=timed["unit"], tol=timed["tol"], ms=fwd_t["ms"], ms_range=fwd_t["range"],
            device_ms=per_call_device_ms(lambda: rmsnorm_mod.rmsnorm(x, w)),
            plain_ms=time_ms(lambda: rmsnorm_mod.rmsnorm_reference(x, w))["ms"],
            library_ms=lib_fwd["ms"] if lib_fwd else None,
            library_ms_range=lib_fwd["range"] if lib_fwd else None, library=lib_fwd_name,
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
            ptxas_names=(fwd_name + ("" if fwd_name.endswith("f16_kernel") else _mangled(dtype)),),
            **common))
        entries.append(dict(
            name=f"rmsnorm_bwd[{label}]", max_abs_err=max(timed["dx_abs"], timed["dw_abs"]),
            err=[timed["dx_err"], timed["dw_err"]], unit=timed["bwd_unit"],
            tol=timed["bwd_tol"], ms=bwd_t["ms"], ms_range=bwd_t["range"],
            device_ms=per_call_device_ms(lambda: rmsnorm_mod.rmsnorm_backward(x, w, dy)),
            plain_ms=time_ms(lambda: rmsnorm_mod._rmsnorm_backward(x, w, dy, 1e-6),
                             iters=5)["ms"], plain="_rmsnorm_backward",
            library_ms=lib_bwd["ms"] if lib_bwd else None,
            library_ms_range=lib_bwd["range"] if lib_bwd else None, library=lib_bwd_name,
            bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
            ptxas_names=(bwd_name + _mangled(dtype),
                         "rmsnorm_dw_scalar_kernelI" if scalar else "rmsnorm_dw_kernelI"),
            **common))
        for entry in entries[-2:]:
            _log_kernel(entry)
        del x, w, dy
    return entries


def phase_kernels() -> list[dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    entries = []

    def flash_times(q, k, v) -> dict:
        # seq_q == seq_k here, where SDPA's top-left causal mask agrees.
        library = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        return dict(
            plain_ms=time_ms(lambda: flash_mod.attention_reference(q, k, v, causal=True))["ms"],
            library_ms=library["ms"], library_ms_range=library["range"],
        )

    checks, kept = [], {}
    for name, b, h, sq, sk, d, causal, dtype, tol in FLASH_CHECKS:
        q = _randn(gen, (b, h, sq, d), dtype)
        k = _randn(gen, (b, h, sk, d), dtype)
        v = _randn(gen, (b, h, sk, d), dtype)
        (out, lse), route = _reported_route(
            (flash_mod.flash_attention,), lambda: flash_mod._flash_forward(q, k, v, causal=causal),
            dtype, d, f"flash {name}",
        )
        torch.cuda.synchronize()
        ref = flash_mod.attention_reference(q, k, v, causal=causal)
        lse_ref = flash_mod._lse_reference(q, k, causal=causal, scale=d ** -0.5)
        err, lse_err = max_err(out, ref), max_err(lse, lse_ref)
        bound_ms, bound_by = _flash_bound(b, h, sq, sk, d, causal, dtype)
        kernel = time_ms(lambda: flash_mod.flash_attention(q, k, v, causal=causal))
        checks.append(dict(
            shape=name, route=route, max_abs_err=err, tol=tol,
            lse_err=lse_err, lse_tol=LSE_TOL[dtype],
            kernel_ms=kernel["ms"], kernel_ms_range=kernel["range"], bound_ms=bound_ms,
        ))
        require(out.dtype == dtype and out.shape == q.shape, f"flash {name}: output shape/dtype")
        require(err < tol, f"flash {name}: max |O - plain| = {err} >= {tol}")
        require(lse_err < LSE_TOL[dtype], f"flash {name}: max |LSE - plain| = {lse_err}")
        if name in (FLASH_TIMED, FLASH_TRAIN):
            kept[name] = (checks[-1], (q, k, v))
    timed, (q, k, v) = kept[FLASH_TIMED]
    train, train_inputs = kept.pop(FLASH_TRAIN)
    bound_ms, bound_by = _flash_bound(*q.shape[:3], k.shape[2], q.shape[3], True, q.dtype)
    entries.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="ray_tpu_torch/ops/csrc/flash_fwd_wgmma.cu",
        replaces="ray_tpu/ops/flash_attention.py:79",
        kernel_route=timed["route"], launches=None, max_abs_err=timed["max_abs_err"],
        err=timed["max_abs_err"], unit="abs", tol=timed["tol"], ms=timed["kernel_ms"],
        ms_range=timed["kernel_ms_range"], **flash_times(q, k, v),
        bound_ms=bound_ms, bound_by=bound_by,
        library="torch.nn.functional.scaled_dot_product_attention",
        shape=FLASH_TIMED, checks=checks,
        at_train_shape=dict(shape=FLASH_TRAIN, ms=train["kernel_ms"],
                            ms_range=train["kernel_ms_range"], bound_ms=train["bound_ms"],
                            **flash_times(*train_inputs)),
    ))
    del kept, train_inputs
    _log_kernel(entries[-1])
    for entry in _bwd_entries(gen):
        entries.append(entry)
        _log_kernel(entry)

    for entry in _rmsnorm_entries(gen):
        entries.append(entry)
        _log_kernel(entry)
    entries += _flash_instantiation_entries(gen)
    entries += _rmsnorm_instantiation_entries(gen)
    log("recorded", measured_by_this_run=False, source=RECORDED_BEFORE_SOURCE,
        before_redesign_ms=RECORDED_BEFORE_MS)
    return entries


def _log_kernel(e: dict) -> None:
    log("kernels", name=e["name"], max_err=e["max_abs_err"], err=e["err"], unit=e["unit"],
        tol=e["tol"],
        kernel_ms=e["ms"], kernel_ms_range=e["ms_range"], plain_ms=e["plain_ms"],
        library_ms=e["library_ms"], library=e["library"],
        bound_ms=e["bound_ms"], bound_by=e["bound_by"], device_ms=e.get("device_ms"),
        at_train_shape=e.get("at_train_shape"), checks=e["checks"])


# ---------------------------------------------------------------- phase 4
class Llama2Encoder:
    """The serving deployment, shaped as release/serve_bert_http.py's
    BertEncoder: bucketed dynamic batching in front of forward."""

    def __init__(self, params: dict, config: TransformerConfig, seq: int):
        self.params, self.config, self.seq = params, config, seq
        self.forwards = 0
        self.flushes = []  # (padded bucket's tokens, its answers' last logits)
        # Warm every batching bucket once, as the JAX deployment compiles them.
        for bucket in BUCKETS:
            self._run(np.zeros((bucket, seq), np.int64))
        torch.cuda.synchronize()

    def _run(self, tokens: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            logits = forward(self.params, torch.from_numpy(tokens).cuda(), self.config)
        self.forwards += 1
        return logits

    @batch(max_batch_size=8, batch_wait_timeout_s=0.005, bucket_sizes=BUCKETS)
    async def __call__(self, bodies: list) -> list:
        tokens = np.zeros((len(bodies), self.seq), np.int64)
        for i, body in enumerate(bodies):
            ids = body["token_ids"][: self.seq]
            tokens[i, : len(ids)] = ids
        last = self._run(tokens)[:, -1].cpu()
        self.flushes.append((tokens, last))
        return [{"logits": row, "next_token": int(row.argmax())} for row in last]


def phase_serve(params: dict, config: TransformerConfig) -> dict:
    rng = np.random.default_rng(SEED + 1)
    start = time.perf_counter()
    encoder = Llama2Encoder(params, config, SERVE_SEQ)
    warm_s = time.perf_counter() - start
    requests = [
        {"token_ids": rng.integers(0, config.vocab_size, SERVE_SEQ).tolist()}
        for _ in range(SERVE_REQUESTS)
    ]

    async def fire():
        return await asyncio.gather(*(encoder(body) for body in requests))

    start = time.perf_counter()
    answers = asyncio.run(fire())
    elapsed = time.perf_counter() - start
    batched_forwards = encoder.forwards - len(BUCKETS)

    errs = []
    for body, answer in zip(requests, answers):
        logits = answer["logits"]
        require(logits.shape == (config.vocab_size,), "serve: answer shape")
        require(bool(torch.isfinite(logits).all()), "serve: non-finite logits")
        alone = encoder._run(np.asarray([body["token_ids"]], np.int64))[0, -1].cpu()
        errs.append(max_err(logits, alone))
    # One full-bucket forward, timed alone and then profiled.
    tokens8 = np.asarray([body["token_ids"] for body in requests[:8]], np.int64)
    torch.cuda.synchronize()
    start = time.perf_counter()
    encoder._run(tokens8)
    torch.cuda.synchronize()
    forward8_ms = (time.perf_counter() - start) * 1e3
    prof = device_time(lambda: encoder._run(tokens8))
    # What a wrong answer would look like: two different requests' logits.
    other = max_err(answers[0]["logits"], answers[1]["logits"])
    require(max(errs) < LOGITS_TOL, f"serve: batched vs unbatched {max(errs)} >= {LOGITS_TOL}")
    result = dict(
        requests=len(answers), seq=SERVE_SEQ, batches=batched_forwards,
        seconds=elapsed, requests_per_s=len(answers) / elapsed,
        prefill_tokens_per_s=len(answers) * SERVE_SEQ / elapsed,
        warmup_seconds=warm_s, max_err_vs_unbatched=max(errs), tol=LOGITS_TOL,
        different_request_diff=other,
        logit_abs_max=float(max(a["logits"].abs().max() for a in answers)),
        forward_b8_ms=forward8_ms, forward_b8_device_ms=prof["device_ms"],
        forward_b8_device_idle_share=1.0 - prof["device_ms"] / forward8_ms,
        forward_b8_top=prof["top"], forwards=encoder.forwards,
    )
    log("serve", **result)
    encoder.params = None  # @batch's queue keeps the encoder, not its weights
    return result


# ---------------------------------------------------------------- phase 5
def phase_generate(params: dict, config: TransformerConfig) -> dict:
    rng = np.random.default_rng(SEED + 2)
    prompts = torch.from_numpy(
        rng.integers(0, config.vocab_size, (GEN_BATCH, GEN_PROMPT))
    ).cuda()
    with torch.inference_mode():
        cache = init_kv_cache(config, GEN_BATCH, GEN_CACHE, device="cuda")
        torch.cuda.synchronize()
        start = time.perf_counter()
        for i in range(GEN_PROMPT):
            logits, cache = decode_step(params, cache, prompts[:, i : i + 1], config)
        torch.cuda.synchronize()
        prompt_s = time.perf_counter() - start
        full = forward(params, prompts, config)[:, -1]
        err = max_err(logits, full)
        require(err < LOGITS_TOL, f"generate: decode vs forward {err} >= {LOGITS_TOL}")
        token = logits.argmax(-1, keepdim=True)
        generated = [token]
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(GEN_NEW - 1):
            logits, cache = decode_step(params, cache, token, config)
            token = logits.argmax(-1, keepdim=True)
            generated.append(token)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - start
        prof = device_time(lambda: decode_step(params, cache, token, config))
    out = torch.cat(generated, dim=1).cpu()
    require(bool(torch.isfinite(logits).all()), "generate: non-finite logits")
    require(out.shape == (GEN_BATCH, GEN_NEW), "generate: token shape")
    require(bool(((out >= 0) & (out < config.vocab_size)).all()), "generate: token range")
    require(int(cache["length"]) == GEN_PROMPT + GEN_NEW - 1, "generate: cache length")
    steps = GEN_PROMPT + GEN_NEW
    step_ms = 1e3 * decode_s / (GEN_NEW - 1)
    result = dict(
        batch=GEN_BATCH, prompt=GEN_PROMPT, new_tokens=GEN_NEW, cache=GEN_CACHE,
        max_err_decode_vs_forward=err, tol=LOGITS_TOL,
        prompt_decode_tokens_per_s=GEN_BATCH * GEN_PROMPT / prompt_s,
        decode_tokens_per_s=GEN_BATCH * (GEN_NEW - 1) / decode_s,
        decode_step_ms=step_ms, decode_step_device_ms=prof["device_ms"],
        decode_device_idle_share=1.0 - prof["device_ms"] / step_ms,
        decode_step_top=prof["top"], decode_steps=steps, forwards=1, first_tokens=out[0, :8].tolist(),
    )
    log("generate", **result)
    return result


# ---------------------------------------------------------------- phase 7
# bench.py:561-565: the JAX package's training main path at full width and
# depth; bench.py:565 and :571 for the batch, the steps and the optimizer.
TRAIN_CONFIG = dict(
    vocab_size=8192, dim=4096, n_layers=3, n_heads=32, n_kv_heads=32, hidden_dim=16384,
    max_seq=1024, dtype=torch.bfloat16,
)
TRAIN_BATCH, TRAIN_STEPS = 12, 10
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16, the MFU denominator
# Kernel path against plain attention and the norm's plain backward in the
# same bf16 model, one step: each gradient leaf by its relative Frobenius
# error. The norm's two backwards differ by f32 sum order and one bf16
# rounding of dx and dw, far below the attention's share. The two attentions
# round P at other places (the kernels unnormalised, the plain version
# normalised), so O and dQ, dK, dV differ by a bf16 ulp (2^-8 relative) in
# some elements; summed over 12,288 tokens those differences add with
# random signs and stay near that level in a leaf's gradient. Bound 5e-2,
# an order above it: a dQ or dK/dV kernel that drops, repeats or
# transposes a tile moves wq's, wk's and wv's gradients by order 1. The
# loss (about ln 8192 = 9.0, from bf16 logits) is held to 1e-2 absolute.
TRAIN_GRAD_REL_TOL = 5e-2
TRAIN_LOSS_TOL = 1e-2


def _rel_frobenius(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _grads(params, leaves, inputs, targets, config) -> tuple:
    """One step's loss and gradients: (loss, grads)."""
    loss = loss_fn(params, inputs, targets, config)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def _plain_grads(params, leaves, inputs, targets, config) -> tuple:
    """_grads through plain attention and the norm's plain backward (swapped
    in for this pass only)."""
    kernel_backward = rmsnorm_mod.rmsnorm_backward
    rmsnorm_mod.rmsnorm_backward = rmsnorm_mod._rmsnorm_backward
    try:
        return _grads(params, leaves, inputs, targets,
                      dataclasses.replace(config, attention="reference"))
    finally:
        rmsnorm_mod.rmsnorm_backward = kernel_backward


def _kernel_and_plain_grads(params, leaves, inputs, targets, config) -> tuple:
    """One step's loss and gradients through the kernels and through the
    plain versions: (loss_k, grads_k, loss_p, grads_p)."""
    return (*_grads(params, leaves, inputs, targets, config),
            *_plain_grads(params, leaves, inputs, targets, config))


def _step_split(params, optimizer, inputs, targets, config, reps: int = 2) -> dict:
    """Wall ms of a train step's forward, backward and optimizer, each
    ended by a synchronize: the mean of `reps` steps."""
    split = {"forward_ms": 0.0, "backward_ms": 0.0, "optimizer_ms": 0.0}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(params, inputs, targets, config)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[key] += 1e3 * dt / reps
    return split


def _launches_per_step(params, optimizer, tokens, config, steps: int) -> tuple:
    """Runs `steps` train steps after a warm-up one; returns the warm-up's
    loss, the steps' losses, their wall seconds and the kernels' launches
    per step."""
    first_loss = float(train_step(params, optimizer, tokens, config))  # warm-up
    before = _counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    losses = [train_step(params, optimizer, tokens, config) for _ in range(steps)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    after = _counts()
    per_step = {name: (after[name] - before[name]) / steps for name in after}
    return first_loss, [float(x) for x in losses], elapsed, per_step


def _expected(layers: int, kernel_forwards: int = 0, kernel_backwards: int = 0,
              plain_forwards: int = 0, decode_steps: int = 0) -> dict:
    """The launches of a path that ran the model's layers in these passes:
    a flash forward a layer and kernel forward, a dQ and a dK/dV a layer and
    kernel backward, and 2 norms a layer and the final one in every pass
    (plain attention keeps the norm's kernels; the plain gradient pass
    swaps in the norm's plain backward)."""
    norms = 2 * layers + 1
    return {
        "flash_attention_fwd": layers * kernel_forwards,
        "flash_attention_bwd_dq": layers * kernel_backwards,
        "flash_attention_bwd_dkv": layers * kernel_backwards,
        "rmsnorm": norms * (kernel_forwards + plain_forwards + decode_steps),
        "rmsnorm_bwd": norms * kernel_backwards,
    }


def phase_train() -> dict:
    """Returns the phase's numbers and how many forward and backward passes
    it ran through the kernels, and forward passes with plain attention."""
    config = TransformerConfig(**TRAIN_CONFIG)
    params = init_params(config, seed=SEED, device="cuda")
    optimizer = make_optimizer(params)
    names, leaves = zip(*named_leaves(params))
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.from_numpy(
        rng.integers(0, config.vocab_size, (TRAIN_BATCH, config.max_seq + 1))
    ).cuda()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    passes = {"kernel_forwards": 0, "kernel_backwards": 0, "plain_forwards": 0}

    # One step's loss and gradients, kernel path against plain attention and
    # the norm's plain backward, swapped in for this pass only.
    loss_k, grads_k, loss_p, grads_p = _kernel_and_plain_grads(
        params, leaves, inputs, targets, config)
    passes["kernel_forwards"] += 1
    passes["kernel_backwards"] += 1
    passes["plain_forwards"] += 1
    grad_errs = {n: _rel_frobenius(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    loss_err = abs(loss_k - loss_p)
    del grads_k, grads_p
    torch.cuda.empty_cache()
    log("train_check", loss_err=loss_err, loss_tol=TRAIN_LOSS_TOL, grad_rel_frobenius=grad_errs,
        grad_tol=TRAIN_GRAD_REL_TOL)
    require(loss_err < TRAIN_LOSS_TOL, f"train: kernel vs plain loss {loss_err}")
    worst = max(grad_errs, key=grad_errs.get)
    require(grad_errs[worst] < TRAIN_GRAD_REL_TOL,
            f"train: {worst} gradient kernel vs plain {grad_errs[worst]} >= {TRAIN_GRAD_REL_TOL}")

    torch.cuda.reset_peak_memory_stats()
    first_loss, losses, elapsed, per_step = _launches_per_step(
        params, optimizer, tokens, config, TRAIN_STEPS)
    passes["kernel_forwards"] += 1 + TRAIN_STEPS
    passes["kernel_backwards"] += 1 + TRAIN_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    layers = config.n_layers
    want_per_step = _expected(layers, kernel_forwards=1, kernel_backwards=1)
    require(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    require(losses[-1] < first_loss, f"train: loss did not fall ({first_loss} -> {losses[-1]})")
    require(per_step == want_per_step, f"train: launches per step {per_step} != {want_per_step}")

    step_ms = 1e3 * elapsed / TRAIN_STEPS
    tokens_per_s = TRAIN_BATCH * config.max_seq / (step_ms / 1e3)
    n_params = num_params(params)
    prof = device_time(lambda: train_step(params, optimizer, tokens, config), top=8)

    # The forward / backward / optimizer split, after the timed window.
    reps = 2
    split = _step_split(params, optimizer, inputs, targets, config, reps)
    passes["kernel_forwards"] += 1 + reps
    passes["kernel_backwards"] += 1 + reps

    result = dict(
        config="bench.py:561-565", layers=layers, dim=config.dim, hidden=config.hidden_dim,
        vocab=config.vocab_size, batch=TRAIN_BATCH, seq=config.max_seq, dtype=str(config.dtype),
        params=n_params, steps=TRAIN_STEPS, first_loss=first_loss, losses=losses,
        step_ms=step_ms, tokens_per_s=tokens_per_s,
        mfu=6.0 * n_params * tokens_per_s / PEAK_BF16_FLOPS, peak_gib=peak_gib,
        step_device_ms=prof["device_ms"], device_idle_share=1.0 - prof["device_ms"] / step_ms,
        step_top=prof["top"], split=split, launches_per_step=per_step,
        grad_check_worst=worst, grad_check_worst_err=grad_errs[worst], **passes,
    )
    log("train", **result)
    return result


# ---------------------------------------------------------------- tiny
# TransformerConfig.tiny(): f32, dim 64, 4 heads over 2 kv heads (head_dim
# 16), 2 layers, vocab 256: the preset of the JAX package's model tests,
# through the kernels (the mma.sync route at head_dim 16, RMSNorm at dim
# 64) against plain attention and the norm's plain backward. Held as
# ROADMAP's parity rules hold f32: the forward (logits, loss) to 2e-5 and
# each gradient leaf to 2e-4, max |kernel - plain|.
TINY_LOGITS_TOL = 2e-5
TINY_GRAD_TOL = 2e-4


def phase_tiny() -> dict:
    config = TransformerConfig.tiny(attention="flash")
    params = init_params(config, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 5)
    tokens = torch.from_numpy(
        rng.integers(0, config.vocab_size, (TINY_BATCH, TINY_SEQ + 1))).cuda()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    with torch.inference_mode():
        logits_k = forward(params, inputs, config)
        logits_p = forward(params, inputs, dataclasses.replace(config, attention="reference"))
    torch.cuda.synchronize()
    logits_err = max_err(logits_k, logits_p)
    optimizer = make_optimizer(params)
    names, leaves = zip(*named_leaves(params))
    loss_k, grads_k, loss_p, grads_p = _kernel_and_plain_grads(
        params, leaves, inputs, targets, config)
    grad_errs = {n: max_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    worst = max(grad_errs, key=grad_errs.get)
    first_loss, losses, _, per_step = _launches_per_step(params, optimizer, tokens, config, 1)
    result = dict(
        config="TransformerConfig.tiny(attention='flash')", head_dim=config.head_dim,
        dtype=str(config.dtype), batch=TINY_BATCH, seq=TINY_SEQ,
        logits_err=logits_err, logits_tol=TINY_LOGITS_TOL, loss_err=abs(loss_k - loss_p),
        grad_err=grad_errs, grad_tol=TINY_GRAD_TOL, first_loss=first_loss, losses=losses,
        launches_per_step=per_step,
        # forwards: 2 inference (kernel, plain), the gradient check's pair,
        # and 2 train steps
        kernel_forwards=4, kernel_backwards=3, plain_forwards=2,
    )
    log("tiny", **result)
    require(bool(torch.isfinite(logits_k).all()), "tiny: non-finite logits")
    require(logits_err < TINY_LOGITS_TOL, f"tiny: kernel vs plain logits {logits_err}")
    require(result["loss_err"] < TINY_LOGITS_TOL, f"tiny: kernel vs plain loss {loss_k}, {loss_p}")
    require(grad_errs[worst] < TINY_GRAD_TOL,
            f"tiny: {worst} gradient kernel vs plain {grad_errs[worst]} >= {TINY_GRAD_TOL}")
    require(all(np.isfinite(losses)), f"tiny: non-finite loss {losses}")
    want = _expected(config.n_layers, kernel_forwards=1, kernel_backwards=1)
    require(per_step == want, f"tiny: launches per step {per_step} != {want}")
    return result


# ---------------------------------------------------------------- MoE
# TransformerConfig.llama2_7b(moe=MoEConfig()): dim 4096, 32 heads and 32
# kv heads (head_dim 128), hidden 11008, vocab 32000, 8 experts, top-2,
# capacity factor 1.25, bf16. Full width; depth cut to fit one card with
# its train state (32 layers would be ~37.0 B parameters, 74 GB in bf16).
MOE_SERVE_LAYERS = 4
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4, 1024, 5
# _moe_mlp on one bf16 h on the card against the same call on the CPU: the
# routing (f32 logits, softmax, top-2, slots) must agree exactly; the
# output rounds to bf16 at five places (gate, up, SwiGLU, expert out,
# combine) after sums in other orders, a few bf16 ulps of values of order
# 1, held to ROADMAP's bf16 forward bound.
MOE_ROUTING_TOKENS = 256


def moe_config(n_layers: int) -> TransformerConfig:
    return TransformerConfig.llama2_7b(moe=MoEConfig(), n_layers=n_layers)


def op_device_ms(fn, op: str) -> float:
    """torch.profiler's device time of the kernels launched under every
    call of `op` in one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
                for e in prof.key_averages() if e.key == op)
    return total / 1e3


def moe_block_ms(params: dict, config: TransformerConfig, tokens: int) -> dict:
    """CUDA-events ms of each part of _moe_mlp at layer 0's weights, for
    `tokens` tokens of random bf16 h routed by the layer's router: the
    routing (_moe_combine), and the einsums as _moe_mlp writes them
    (dispatch; the experts' gate and up; their down; the combine)."""
    layer = {name: params["layers"][name][0] for name in ("router", "w_gate", "w_up", "w_down")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    ht = torch.randn((tokens, config.dim), generator=gen, device="cuda").to(config.dtype)
    moe = config.moe
    with torch.inference_mode():
        combine = transformer_mod._moe_combine(ht, layer["router"], moe)
        dispatch, weights = (combine > 0).to(ht.dtype), combine.to(ht.dtype)
        expert_in = torch.einsum("tec,td->ecd", dispatch, ht)
        gate = torch.einsum("ecd,edm->ecm", expert_in, layer["w_gate"]).to(ht.dtype)
        up = torch.einsum("ecd,edm->ecm", expert_in, layer["w_up"]).to(ht.dtype)
        act = transformer_mod._silu_mul(gate, up)
        expert_out = torch.einsum("ecm,emd->ecd", act, layer["w_down"])
        parts = {
            "routing": lambda: transformer_mod._moe_combine(ht, layer["router"], moe),
            "dispatch_einsum": lambda: torch.einsum("tec,td->ecd", dispatch, ht),
            "expert_gate_up_einsums": lambda: (
                torch.einsum("ecd,edm->ecm", expert_in, layer["w_gate"]),
                torch.einsum("ecd,edm->ecm", expert_in, layer["w_up"])),
            "expert_down_einsum": lambda: torch.einsum("ecm,emd->ecd", act, layer["w_down"]),
            "combine_einsum": lambda: torch.einsum("tec,ecd->td", weights, expert_out),
        }
        return {name: time_ms(fn, iters=10)["ms"] for name, fn in parts.items()}


def _moe_routing_check(params: dict, config: TransformerConfig) -> dict:
    layer = {name: params["layers"][name][0] for name in ("router", "w_gate", "w_up", "w_down")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    h = torch.randn((1, MOE_ROUTING_TOKENS, config.dim), generator=gen,
                    device="cuda").to(config.dtype)
    cpu_layer = {name: t.cpu() for name, t in layer.items()}
    with torch.inference_mode():
        out = transformer_mod._moe_mlp(h, layer, config).cpu()
        combine = transformer_mod._moe_combine(h[0], layer["router"], config.moe).cpu()
        out_cpu = transformer_mod._moe_mlp(h.cpu(), cpu_layer, config)
        combine_cpu = transformer_mod._moe_combine(h[0].cpu(), cpu_layer["router"], config.moe)
    dispatch, dispatch_cpu = combine > 0, combine_cpu > 0
    result = dict(tokens=MOE_ROUTING_TOKENS, capacity=combine.shape[-1],
                  dispatch_equal=bool(torch.equal(dispatch, dispatch_cpu)),
                  tokens_routed_differently=int((dispatch != dispatch_cpu).flatten(1).any(1).sum()),
                  combine_max_err=max_err(combine, combine_cpu),
                  out_max_err=max_err(out, out_cpu), out_tol=BF16_TOL,
                  out_abs_max=float(out_cpu.float().abs().max()))
    require(result["dispatch_equal"], f"moe routing: card and CPU dispatch differ: {result}")
    require(result["out_max_err"] < BF16_TOL, f"moe routing: card vs CPU output {result}")
    return result


def phase_moe_serve(params: dict, config: TransformerConfig) -> dict:
    rng = np.random.default_rng(SEED + 4)
    start = time.perf_counter()
    encoder = Llama2Encoder(params, config, SERVE_SEQ)
    warm_s = time.perf_counter() - start
    requests = [
        {"token_ids": rng.integers(0, config.vocab_size, SERVE_SEQ).tolist()}
        for _ in range(SERVE_REQUESTS)
    ]

    async def fire():
        return await asyncio.gather(*(encoder(body) for body in requests))

    start = time.perf_counter()
    answers = asyncio.run(fire())
    elapsed = time.perf_counter() - start
    for answer in answers:
        require(answer["logits"].shape == (config.vocab_size,), "moe serve: answer shape")
        require(bool(torch.isfinite(answer["logits"]).all()), "moe serve: non-finite logits")
    # A bucket's capacity and its padding rows decide the routing (the
    # reference's semantics), so each batched answer is held against a
    # direct forward on the same padded bucket, not against its request
    # alone.
    buckets = []
    for tokens, last in encoder.flushes:
        direct = encoder._run(tokens)[:, -1].cpu()
        buckets.append(dict(bucket=tokens.shape[0], bitwise_equal=bool(torch.equal(last, direct)),
                            max_err=max_err(last, direct)))
    require(all(b["bitwise_equal"] for b in buckets),
            f"moe serve: batched answers differ from a direct forward: {buckets}")
    alone = encoder._run(np.asarray([requests[0]["token_ids"]], np.int64))[0, -1].cpu()
    tokens8 = np.asarray([body["token_ids"] for body in requests[:8]], np.int64)
    torch.cuda.synchronize()
    start = time.perf_counter()
    encoder._run(tokens8)
    torch.cuda.synchronize()
    forward8_ms = (time.perf_counter() - start) * 1e3
    prof = device_time(lambda: encoder._run(tokens8), top=8)
    einsum_ms = op_device_ms(lambda: encoder._run(tokens8), "aten::einsum")
    parts = moe_block_ms(params, config, 8 * SERVE_SEQ)
    result = dict(
        config="llama2_7b(moe=MoEConfig(), n_layers=4)", layers=config.n_layers,
        params=num_params(params), experts=config.moe.num_experts, top_k=config.moe.top_k,
        capacity_b8=transformer_mod.moe_capacity(config.moe, 8 * SERVE_SEQ),
        requests=len(answers), seq=SERVE_SEQ, batches=len(encoder.flushes), seconds=elapsed,
        prefill_tokens_per_s=len(answers) * SERVE_SEQ / elapsed, warmup_seconds=warm_s,
        buckets=buckets,
        batched_vs_alone_diff=max_err(answers[0]["logits"], alone),
        different_request_diff=max_err(answers[0]["logits"], answers[1]["logits"]),
        forward_b8_ms=forward8_ms, forward_b8_device_ms=prof["device_ms"],
        forward_b8_device_idle_share=1.0 - prof["device_ms"] / forward8_ms,
        forward_b8_top=prof["top"], moe_einsum_device_ms=einsum_ms,
        moe_einsum_device_share=einsum_ms / prof["device_ms"],
        moe_block_ms_per_layer=parts,
        moe_block_share_b8={name: config.n_layers * ms / prof["device_ms"]
                            for name, ms in parts.items()},
        routing=_moe_routing_check(params, config), forwards=encoder.forwards,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    log("moe_serve", **result)
    encoder.params = None  # @batch's queue keeps the encoder, not its weights
    return result


def phase_stages(params: dict, config: TransformerConfig) -> dict:
    """partition_stages into 2 stages, stage_forward chained against the
    fused forward (bf16 logits, ROADMAP's bf16 forward bound), and
    merge_stages back to the same tree."""
    rng = np.random.default_rng(SEED + 8)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, (2, SERVE_SEQ))).cuda()
    stages = partition_stages(params, config, 2)
    with torch.inference_mode():
        x = tokens
        for s, tree in enumerate(stages):
            x = stage_forward(tree, x, config, first=s == 0, last=s == len(stages) - 1)
        fused = forward(params, tokens, config)
    torch.cuda.synchronize()
    merged = merge_stages(stages)
    restored = [(n, torch.equal(a, b) and a.dtype == b.dtype)
                for (n, a), (_, b) in zip(named_leaves(merged), named_leaves(params))]
    result = dict(stages=len(stages), layers_per_stage=config.n_layers // len(stages),
                  stage_leaves=[sorted(dict(named_leaves(t))) for t in stages],
                  max_err=max_err(x, fused), tol=BF16_TOL, bitwise_equal=bool(torch.equal(x, fused)),
                  merged_equal=all(ok for _, ok in restored), forwards=2)
    del merged
    log("stages", **result)
    require(bool(torch.isfinite(x).all()), "stages: non-finite logits")
    require(result["max_err"] < BF16_TOL, f"stages: chain vs fused {result['max_err']}")
    require(result["merged_equal"] and len(restored) == len(list(named_leaves(params))),
            f"stages: merge_stages does not give the tree back: {restored}")
    return result


def moe_train_flops(config: TransformerConfig, batch: int, seq: int) -> dict:
    """Operations (2 per multiply-add) of one train step's matrix products
    and einsums, from their shapes: the forward's, and the backward's as
    autograd and the kernels run them: 2 products for each weight product
    (dX and dW), 1 for the dispatch einsum (its 0/1 dispatch takes no
    gradient), 2 for the combine (dcombine, dexpert_out), and the flash
    backward's 7 products per visible pair (dQ kernel 3, dK/dV kernel 4)
    against the forward's 2. Elementwise work (norms, RoPE, SwiGLU,
    routing, softmax, Adam) is left out."""
    tokens, d, hd = batch * seq, config.dim, config.head_dim
    experts, hidden = config.moe.num_experts, config.hidden_dim
    capacity = transformer_mod.moe_capacity(config.moe, tokens)
    pairs = batch * config.n_heads * _causal_pairs(seq, seq, True)
    q_out, kv_out = config.n_heads * hd, config.n_kv_heads * hd
    layer = {  # forward operations, backward multiple
        "attention_projections": (2 * tokens * d * (q_out + 2 * kv_out) + 2 * tokens * q_out * d,
                                  2.0),
        "attention_flash": (2 * 2 * hd * pairs, 3.5),
        "moe_router": (2 * tokens * d * experts, 2.0),
        "moe_dispatch_einsum": (2 * tokens * experts * capacity * d, 1.0),
        "moe_expert_einsums": (3 * 2 * experts * capacity * d * hidden, 2.0),
        "moe_combine_einsum": (2 * tokens * experts * capacity * d, 2.0),
    }
    head = 2 * tokens * d * config.vocab_size
    forward_ops = config.n_layers * sum(f for f, _ in layer.values()) + head
    backward_ops = config.n_layers * sum(f * m for f, m in layer.values()) + 2 * head
    return dict(capacity=capacity, per_layer_forward={k: f for k, (f, _) in layer.items()},
                lm_head_forward=head, forward=forward_ops, backward=backward_ops,
                step=forward_ops + backward_ops)


def phase_moe_train() -> dict:
    """Returns the phase's numbers and how many forward and backward passes
    it ran through the kernels, and forward passes with plain attention."""
    held_gib = torch.cuda.memory_allocated() / 2**30  # by earlier phases
    config = moe_config(MOE_TRAIN_LAYERS)
    params = init_params(config, seed=SEED, device="cuda")
    optimizer = make_optimizer(params)
    names, leaves = zip(*named_leaves(params))
    rng = np.random.default_rng(SEED + 7)
    tokens = torch.from_numpy(
        rng.integers(0, config.vocab_size, (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ + 1))).cuda()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    passes = {"kernel_forwards": 1, "kernel_backwards": 1, "plain_forwards": 2}
    layers = config.n_layers

    # Routing is a discrete choice: where two experts' probabilities are
    # within the paths' rounding of each other, the kernel and plain passes
    # send a token to different experts, and its gradient differs by order
    # 1. The kernels are held with the routing pinned: the plain pass
    # replays the kernel pass's dispatch with its own gates (the
    # reference's combine is the dispatch times the chosen experts'
    # probabilities, which the kernel pass checks). The free plain pass is
    # run too: its loss, gradients and the tokens it routes otherwise are
    # reported, not held.
    combine_fn = transformer_mod._moe_combine
    dispatch = {"kernel": [], "free": []}
    identity_held = []

    def _probs(ht, router):
        return torch.softmax(ht.float() @ router.float(), dim=-1)

    def recording(into):
        def record(ht, router, moe, ctx=None):
            combine = combine_fn(ht, router, moe, ctx)
            dispatch[into].append(combine > 0)
            identity_held.append(bool(torch.equal(
                combine, dispatch[into][-1] * _probs(ht, router)[:, :, None])))
            return combine
        return record

    def replaying(ht, router, moe, ctx=None):
        layer = len(dispatch.setdefault("replayed", []))
        dispatch["replayed"].append(None)
        return dispatch["kernel"][layer] * _probs(ht, router)[:, :, None]

    try:
        transformer_mod._moe_combine = recording("kernel")
        loss_k, grads_k = _grads(params, leaves, inputs, targets, config)
        transformer_mod._moe_combine = recording("free")
        loss_f, grads_f = _plain_grads(params, leaves, inputs, targets, config)
        free_errs = {n: _rel_frobenius(a, b) for n, a, b in zip(names, grads_k, grads_f)}
        del grads_f
        transformer_mod._moe_combine = replaying
        loss_p, grads_p = _plain_grads(params, leaves, inputs, targets, config)
    finally:
        transformer_mod._moe_combine = combine_fn
    flips = [int((a.any(-1) != b.any(-1)).any(-1).sum())
             for a, b in zip(dispatch["kernel"], dispatch["free"])]
    grad_errs = {n: _rel_frobenius(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    loss_err = abs(loss_k - loss_p)
    del grads_k, grads_p, dispatch
    torch.cuda.empty_cache()
    worst = max(grad_errs, key=grad_errs.get)
    check = dict(loss_err=loss_err, loss_tol=TRAIN_LOSS_TOL, grad_rel_frobenius=grad_errs,
                 grad_tol=TRAIN_GRAD_REL_TOL, combine_is_dispatch_times_probs=identity_held,
                 free_routing=dict(tokens_routed_differently_by_layer=flips,
                                   tokens=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ,
                                   loss_err=abs(loss_k - loss_f),
                                   grad_rel_frobenius=free_errs))
    log("moe_train_check", **check)
    require(all(identity_held) and len(identity_held) == 2 * layers,
            f"moe train: combine is not dispatch * probs: {identity_held}")
    require(loss_err < TRAIN_LOSS_TOL, f"moe train: kernel vs plain loss {loss_err}")
    require(grad_errs[worst] < TRAIN_GRAD_REL_TOL,
            f"moe train: {worst} gradient kernel vs plain {grad_errs[worst]} "
            f">= {TRAIN_GRAD_REL_TOL}")

    torch.cuda.reset_peak_memory_stats()
    first_loss, losses, elapsed, per_step = _launches_per_step(
        params, optimizer, tokens, config, MOE_TRAIN_STEPS)
    passes["kernel_forwards"] += 1 + MOE_TRAIN_STEPS
    passes["kernel_backwards"] += 1 + MOE_TRAIN_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want_per_step = _expected(layers, kernel_forwards=1, kernel_backwards=1)
    require(all(np.isfinite(losses)), f"moe train: non-finite loss {losses}")
    require(losses[-1] < first_loss, f"moe train: loss did not fall ({first_loss} -> {losses[-1]})")
    require(per_step == want_per_step,
            f"moe train: launches per step {per_step} != {want_per_step}")
    step_ms = 1e3 * elapsed / MOE_TRAIN_STEPS
    prof = device_time(lambda: train_step(params, optimizer, tokens, config), top=8)
    reps = 2
    split = _step_split(params, optimizer, inputs, targets, config, reps)
    passes["kernel_forwards"] += 1 + reps
    passes["kernel_backwards"] += 1 + reps
    flops = moe_train_flops(config, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)
    result = dict(
        config="llama2_7b(moe=MoEConfig(), n_layers=2)", layers=layers, dim=config.dim,
        hidden=config.hidden_dim, experts=config.moe.num_experts, top_k=config.moe.top_k,
        batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ, dtype=str(config.dtype),
        params=num_params(params), steps=MOE_TRAIN_STEPS, first_loss=first_loss, losses=losses,
        step_ms=step_ms, tokens_per_s=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (step_ms / 1e3),
        flops=flops, matmul_tflops_per_s=flops["step"] / (step_ms / 1e3) / 1e12,
        matmul_share_of_peak=flops["step"] / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        peak_gib=peak_gib, held_at_start_gib=held_gib, step_device_ms=prof["device_ms"],
        device_idle_share=1.0 - prof["device_ms"] / step_ms, step_top=prof["top"],
        split=split, launches_per_step=per_step, grad_check_worst=worst,
        grad_check_worst_err=grad_errs[worst], grad_check=check, **passes,
    )
    log("moe_train", **result)
    return result


# ---------------------------------------------------------------- sharded_train
# bench.py:133-138: the JAX package's sharded benchmark (bench.py --sharding)
# on an accelerator, at its batch for one device (4 x n_dev, bench.py:139).
# One card: the mesh has one rank, so every collective is of one rank and
# the step runs the single-device step's ops; the multi-rank math is held
# on the CPU by tests/test_torch_sharded.py.
SHARDED_CONFIG = dict(
    vocab_size=8192, dim=4096, n_layers=4, n_heads=32, n_kv_heads=32, hidden_dim=16384,
    max_seq=1024, dtype=torch.bfloat16,
)
SHARDED_MESH = {"dp": 1, "fsdp": 1, "tp": 1}
SHARDED_BATCH, SHARDED_STEPS, SHARDED_CHECK_STEPS = 4, 10, 3
# Sharded step against train_step from the same parameters and batch. The
# ops are the same, so bitwise equality is expected and reported; where it
# does not hold, the loss is held to 3e-2 (bf16 logits of a loss near
# ln 8192 = 9.0) and each leaf's update over the check's steps to 10% of
# that leaf's largest update: AdamW's first steps are near lr a element,
# and an update taken from a wrong gradient differs by its own size.
SHARDED_LOSS_TOL = 3e-2
SHARDED_UPDATE_TOL = 0.1


def _sharded_budget(mesh) -> dict:
    """The plan of TransformerConfig.llama2_7b() on the one-rank mesh: in
    f32 setup_sharded_training refuses it before allocating anything; in
    bf16 the plan is accepted."""
    budget = device_memory_budget()
    inits, plans = {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        config = TransformerConfig.llama2_7b(dtype=dtype)
        inits[name] = (functools.partial(init_params, config, SEED), param_logical_dims(config))
        _, _, estimate = plan_sharded_training(inits[name][0], mesh=mesh,
                                               logical_dims=inits[name][1], enforce_budget=False)
        plans[name] = estimate
    before = torch.cuda.memory_allocated()
    try:
        setup_sharded_training(inits["f32"][0], make_optimizer, mesh=mesh,
                               logical_dims=inits["f32"][1])
        refusal = None
    except MemoryBudgetError as err:
        refusal = str(err)
    moved = torch.cuda.memory_allocated() - before
    require(refusal is not None and moved == 0,
            f"sharded_train: the f32 llama2_7b setup was not refused before allocating "
            f"({moved} bytes moved)")
    plan_sharded_training(inits["bf16"][0], mesh=mesh, logical_dims=inits["bf16"][1])
    return dict(budget_bytes=budget, llama2_7b_f32_bytes=plans["f32"],
                llama2_7b_bf16_bytes=plans["bf16"], f32_refusal=refusal,
                allocated_moved_by_refusal=moved)


def _timed_steps(run_step, steps: int) -> tuple:
    """One warm-up step and `steps` timed ones; (warm-up loss, losses,
    seconds, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    first = float(run_step())
    torch.cuda.synchronize()
    start = time.perf_counter()
    losses = [run_step() for _ in range(steps)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    return first, [float(x) for x in losses], elapsed, torch.cuda.max_memory_allocated() / 2**30


def phase_sharded_train() -> dict:
    """setup_sharded_training and build_sharded_train_step at bench.py's
    sharded config on a one-rank NCCL mesh: the budget check, three steps
    against train_step, then timed steps of each. Returns the numbers and
    the passes it ran through the kernels."""
    import torch.distributed as dist

    config = TransformerConfig(**SHARDED_CONFIG)
    mesh = MeshSpec(SHARDED_MESH).build()
    try:
        budget = _sharded_budget(mesh)

        def init(device):
            return init_params(config, seed=SEED, device=device)

        setup = setup_sharded_training(init, make_optimizer, mesh=mesh,
                                       logical_dims=param_logical_dims(config))

        def batch_loss(params, tok):
            return loss_fn(params, tok[:, :-1], tok[:, 1:], config)

        step = build_sharded_train_step(batch_loss, setup)
        ref = init("cuda")
        ref_opt = make_optimizer(ref)
        rng = np.random.default_rng(SEED + 11)
        tokens = torch.from_numpy(
            rng.integers(0, config.vocab_size, (SHARDED_BATCH, config.max_seq + 1))).cuda()
        batch = setup.shard_batch(tokens)
        names = [n for n, _ in named_leaves(ref)]
        init_leaves = [leaf.detach().clone() for _, leaf in named_leaves(ref)]
        require(all(torch.equal(a.full_tensor(), b) for (_, a), b in
                    zip(named_leaves(setup.params), init_leaves)),
                "sharded_train: the sharded and single-device inits differ")

        # Three steps of each from the same parameters and batch.
        params, opt_state = setup.params, setup.opt_state
        sharded_losses, ref_losses = [], []
        for _ in range(SHARDED_CHECK_STEPS):
            params, opt_state, loss = step(params, opt_state, batch)
            sharded_losses.append(loss)
            ref_losses.append(train_step(ref, ref_opt, tokens, config))
        torch.cuda.synchronize()
        got = [leaf.detach().full_tensor() for _, leaf in named_leaves(params)]
        want = [leaf.detach() for _, leaf in named_leaves(ref)]
        bitwise = (all(torch.equal(a, b) for a, b in zip(sharded_losses, ref_losses))
                   and all(torch.equal(a, b) for a, b in zip(got, want)))
        loss_err = max(abs(float(a) - float(b)) for a, b in zip(sharded_losses, ref_losses))
        update_err = {}
        for name, a, b, w0 in zip(names, got, want, init_leaves):
            ref_update = b.float() - w0.float()
            update_err[name] = float((a.float() - b.float()).abs().max()
                                     / ref_update.abs().max().clamp_min(1e-30))
        worst = max(update_err, key=update_err.get)
        check = dict(steps=SHARDED_CHECK_STEPS, bitwise=bitwise, loss_err=loss_err,
                     loss_tol=SHARDED_LOSS_TOL, worst_update_err=update_err[worst],
                     worst_leaf=worst, update_tol=SHARDED_UPDATE_TOL,
                     held="bitwise" if bitwise else "tolerance",
                     sharded_losses=[float(x) for x in sharded_losses],
                     train_step_losses=[float(x) for x in ref_losses])
        log("sharded_check", **check)
        if not bitwise:
            require(loss_err < SHARDED_LOSS_TOL and update_err[worst] < SHARDED_UPDATE_TOL,
                    f"sharded_train: sharded step vs train_step: loss {loss_err}, "
                    f"{worst} update {update_err[worst]}")
        del ref, ref_opt, got, want, init_leaves, ref_losses
        torch.cuda.empty_cache()

        # The sharded step alone, then train_step alone, timed.
        state = {"params": params, "opt": opt_state}

        def sharded_step():
            state["params"], state["opt"], loss = step(state["params"], state["opt"], batch)
            return loss

        first, losses, elapsed, peak = _timed_steps(sharded_step, SHARDED_STEPS)
        require(all(np.isfinite(losses)), f"sharded_train: non-finite loss {losses}")
        require(losses[-1] < first,
                f"sharded_train: loss did not fall ({first} -> {losses[-1]})")
        calls = dict(tp_mod.calls)
        require(calls["tp"] > 0 and calls["fsdp"] > 0,
                f"sharded_train: tp and fsdp collectives not counted: {calls}")
        n_params = sum(leaf.numel() for _, leaf in named_leaves(state["params"]))
        del state, params, opt_state, setup, step
        torch.cuda.empty_cache()
        ref = init("cuda")
        ref_opt = make_optimizer(ref)
        ref_first, ref_losses, ref_elapsed, ref_peak = _timed_steps(
            lambda: train_step(ref, ref_opt, tokens, config), SHARDED_STEPS)
        del ref, ref_opt
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    tokens_per_step = SHARDED_BATCH * config.max_seq
    steps = SHARDED_CHECK_STEPS + 1 + SHARDED_STEPS
    result = dict(
        config="bench.py:133-138", mesh=SHARDED_MESH, layers=config.n_layers, dim=config.dim,
        hidden=config.hidden_dim, vocab=config.vocab_size, batch=SHARDED_BATCH,
        seq=config.max_seq, dtype=str(config.dtype), params=n_params, check=check,
        first_loss=first, losses=losses, step_ms=1e3 * elapsed / SHARDED_STEPS,
        tokens_per_s=tokens_per_step * SHARDED_STEPS / elapsed, peak_gib=peak,
        train_step_ms=1e3 * ref_elapsed / SHARDED_STEPS,
        train_step_tokens_per_s=tokens_per_step * SHARDED_STEPS / ref_elapsed,
        train_step_peak_gib=ref_peak, train_step_losses=ref_losses, collective_calls=calls,
        budget=budget, kernel_forwards=2 * steps, kernel_backwards=2 * steps, plain_forwards=0,
    )
    log("sharded_train", **result)
    return result


# ---------------------------------------------------------------- phase 13
def phase_collectives() -> dict:
    """A one-rank NCCL group: every op with the reference's world-size-1
    semantics (each returns its input; reducescatter flattens it), the
    refusals, and the bucketed asynchronous gradient sync, whose NCCL
    all-reduces run even at one rank, against sync_gradients. The group is
    destroyed at the end, and the process group with it."""
    import torch.distributed as dist

    require(not dist.is_initialized(), "collectives: a process group is already up")
    collective_mod.init_collective_group(1, 0, backend="nccl", group_name="smoke")
    checks = {}
    try:
        group = collective_mod.get_group("smoke")
        require(dist.get_backend() == "nccl", f"collectives: backend {dist.get_backend()}")
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        t = torch.arange(12, dtype=torch.bfloat16, device="cuda").reshape(3, 4)
        for op in ("sum", "product", "min", "max"):
            checks[f"allreduce_{op}"] = bool(np.array_equal(group.allreduce(x, op=op), x)
                                             and group.allreduce(t, op=op) is t)
        checks["allgather"] = [np.array_equal(a, x) for a in group.allgather(x)] == [True]
        checks["broadcast"] = bool(np.array_equal(group.broadcast(x), x))
        checks["reducescatter"] = bool(np.array_equal(group.reducescatter(x), x.reshape(-1)))
        group.barrier()
        for name, call in (("p2p_self", lambda: group.p2p(x, 0, 0)),
                           ("recv_without_like", lambda: group.recv(0)),
                           ("unknown_op", lambda: group.allreduce(x, op="mean"))):
            try:
                call()
                checks[name] = False
            except ValueError:
                checks[name] = True
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        grads = {f"w{i}": _randn(gen, (1024, 1024), torch.bfloat16) for i in range(3)}
        grads["b"] = _randn(gen, (4096,), torch.float32)
        handle = begin_gradient_sync(grads, "smoke", bucket_bytes=4 << 20)
        overlapped = handle.result()
        plain = sync_gradients(grads, "smoke")
        checks["bucketed_sync"] = all(torch.equal(overlapped[k], plain[k]) for k in grads)
        stats = dict(handle.stats)
    finally:
        collective_mod.destroy_collective_group("smoke")
    checks["destroyed"] = not dist.is_initialized()
    log("collectives", checks=checks, bucketed_sync_stats=stats)
    require(all(checks.values()), f"collectives: {checks}")
    return {"checks": checks, "bucketed_sync_stats": stats}


# ---------------------------------------------------------------- phase 14
# The trainer phase: bench.py's sharded config at TRAINER_LAYERS layers
# through TorchTrainer on one GPU worker. The loop takes TRAINER_STEPS steps and saves at
# TRAINER_SAVE_AT; in the run that fails, the worker exits hard after
# TRAINER_DIE_AFTER's report and the trainer restarts it from that save.
TRAINER_STEPS, TRAINER_SAVE_AT, TRAINER_DIE_AFTER = 6, 3, 4
# The config's depth, cut from 4 layers to 2 to keep the script inside its
# time limit; every check of the phase holds at any depth.
TRAINER_LAYERS = 2
TRAINER_STORAGE = Path(__file__).resolve().parent / "build" / "chip_smoke_trainer"
# bf16 params and AdamW's two bf16 moments (604,000,256 parameters at 2
# layers), plus the step count.
TRAINER_CKPT_BYTES = 3 * 2 * 604_000_256


def _trainer_batch(step: int, config: TransformerConfig) -> torch.Tensor:
    """Step ``step``'s tokens, from a generator seeded by the step's index,
    so that a resumed run sees the same data."""
    rng = np.random.default_rng(SEED + 1000 + step)
    return torch.from_numpy(rng.integers(0, config.vocab_size,
                                         (SHARDED_BATCH, config.max_seq + 1)))


def _params_digest(params) -> list[int]:
    """Two integer sums over every parameter's bits (plain and weighted by
    position): equal for equal parameters, bit for bit."""
    total, weighted = 0, 0
    for _, leaf in named_leaves(params):
        bits = leaf.detach().full_tensor().reshape(-1).view(torch.int16).to(torch.int64)
        total += int(bits.sum())
        weighted += int((bits * (torch.arange(bits.numel(), device=bits.device) % 8191 + 1))
                        .sum())
    return [total, weighted]


def trainer_loop(loop_config: dict) -> None:
    """TorchTrainer's train_loop_per_worker: setup_sharded_training and
    build_sharded_train_step on the session's mesh, a report a step, a save
    at TRAINER_SAVE_AT; restores from the session's checkpoint when there is
    one. Each report carries the worker's kernel launch counts since the
    loop began (the counts live in this process). Phase 22 runs it with
    ``save`` False, ``split`` True (the split step over the gang's group,
    whose scopes a capture traces; the dispatch takes it only above one
    worker) and ``probe`` True (the HBM probe and the card's memory in each
    report); phase 25 with fewer ``n_layers`` and ``steps``, an earlier
    ``save_at``, and ``dataset`` True: its tokens then come from the
    trainer's dataset ``"train"`` (rows of ``release_loops.token_rows``,
    SHARDED_BATCH of them a step), and each report carries the ids of the
    rows its step consumed."""
    reset_counts()
    ctx = session_mod.get_context()
    config = TransformerConfig(**{**SHARDED_CONFIG, "n_layers": loop_config.get(
        "n_layers", SHARDED_CONFIG["n_layers"])})
    steps = loop_config.get("steps", TRAINER_STEPS)
    save_at = loop_config.get("save_at", TRAINER_SAVE_AT)
    setup = setup_sharded_training(lambda device: init_params(config, seed=SEED, device=device),
                                   make_optimizer, logical_dims=param_logical_dims(config))

    def batch_loss(params, tok):
        return loss_fn(params, tok[:, :-1], tok[:, 1:], config)

    if loop_config.get("split"):
        step = torch_utils._split_step(batch_loss, setup, ctx.collective_group,
                                       lambda x: x.to_local())
    else:
        step = build_sharded_train_step(batch_loss, setup)
    start, resumed, restore_s = 0, session_mod.get_checkpoint(), None
    if resumed is not None:
        t0 = time.perf_counter()
        _, _, extra = restore_sharded_state(resumed, setup)
        torch.cuda.synchronize()
        restore_s, start = time.perf_counter() - t0, extra["step"]
    params, opt = setup.params, setup.opt_state
    init_digest = _params_digest(params) if resumed is None else None
    rows = (iter(session_mod.get_dataset_shard("train").iter_torch_batches(
        batch_size=SHARDED_BATCH)) if loop_config.get("dataset") else None)
    for i in range(start, steps):
        ids = None
        if rows is not None:
            taken = next(rows)
            tokens, ids = taken["tokens"], taken["id"].tolist()
        else:
            tokens = _trainer_batch(i, config)
        batch = setup.shard_batch(tokens.cuda())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        loss = float(loss)
        metrics = {"step": i + 1, "loss": loss, "step_s": time.perf_counter() - t0,
                   "restore_s": restore_s, "pid": os.getpid(), "counts": _counts(),
                   "routes": _route_counts(), "world": ctx.world_size, "ids": ids}
        if loop_config.get("probe"):
            metrics.update(hbm=telemetry.hbm_stats(), allocated=torch.cuda.memory_allocated(),
                           total_memory=torch.cuda.get_device_properties(0).total_memory)
        checkpoint = None
        if i + 1 == save_at and loop_config.get("save", True):
            t0 = time.perf_counter()
            checkpoint = save_sharded_state(params, opt, extra={"step": i + 1})
            metrics["save_s"] = time.perf_counter() - t0
            metrics["ckpt_bytes"] = sum(f.stat().st_size for f in
                                        Path(checkpoint.path).rglob("*") if f.is_file())
        if i == 0:  # the parameters before and after the first update
            metrics["init_digest"], metrics["digest"] = init_digest, _params_digest(params)
        if i + 1 == steps:
            metrics["digest"] = _params_digest(params)
            metrics["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        session_mod.report(metrics, checkpoint=checkpoint)
        if loop_config.get("die_after") == i + 1 and resumed is None:
            if loop_config.get("mid_save_log") and ctx.world_rank == 0:
                # The reference's torn-save kill: the armed fail point fires
                # between the save's shards and its commit marker, and the
                # process ends there (tests/test_checkpoint_commit.py).
                chaos_mod.install(
                    FaultSchedule(seed=0, fail_points={"train.checkpoint.mid_save": 1}),
                    identity="trainer-rank0", log_dir=loop_config["mid_save_log"],
                    export_env=False)
                try:
                    save_sharded_state(params, opt, extra={"step": i + 1})
                except chaos_mod.ChaosFault:
                    _note_death(loop_config)
                    os._exit(1)
                raise RuntimeError("trainer: the armed mid-save fail point did not fire")
            _note_death(loop_config)
            os._exit(1)
    require_no_reference("trainer worker")


def _note_death(loop_config: dict) -> None:
    """The wall time (``time.time()``) at which this worker exits, in the
    config's ``death_file``: the restart's clock starts there."""
    if loop_config.get("death_file"):
        Path(loop_config["death_file"]).write_text(repr(time.time()))


def _trainer_run(name: str, die_after: int | None, mid_save_log: str | None = None):
    """One fit; with ``mid_save_log`` the killed worker dies inside a torn
    save (its chaos events logged there). Returns the result and the torn
    saves left in the trial directory, each with its verdict, and the step
    of the trial's latest committed checkpoint."""
    trainer = TorchTrainer(
        trainer_loop, train_loop_config={"die_after": die_after, "n_layers": TRAINER_LAYERS,
                                         "mid_save_log": mid_save_log,
                                         "death_file": str(TRAINER_STORAGE / f"{name}.death")},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True, mesh_axes=SHARDED_MESH),
        run_config=RunConfig(name=name, storage_path=str(TRAINER_STORAGE),
                             failure_config=FailureConfig(max_failures=1),
                             checkpoint_config=CheckpointConfig(num_to_keep=1)))
    result = trainer.fit()
    torn = [(p.name, *verify_sharded_checkpoint(str(p)))
            for p in sorted(Path(result.path).glob("ray_tpu_ckpt_*")) if p.is_dir()]
    latest = StorageContext(str(TRAINER_STORAGE), name).latest_checkpoint()
    latest_step = None
    if latest is not None:
        with open(Path(latest.path) / "extra.pkl", "rb") as f:
            latest_step = pickle.load(f)["step"]
    shutil.rmtree(result.path, ignore_errors=True)
    require(result.error is None, f"trainer {name}: {result.error}")
    death = TRAINER_STORAGE / f"{name}.death"
    result.died_at = float(death.read_text()) if death.exists() else None
    return result, torn, latest_step


def phase_trainer(sharded_step_ms: float) -> dict:
    """TorchTrainer with one GPU worker at bench.py's sharded config, cut to
    TRAINER_LAYERS layers (``sharded_step_ms`` is phase 12's at 4): a run
    whose worker exits hard after step TRAINER_DIE_AFTER's report and is
    restarted from the step-TRAINER_SAVE_AT checkpoint, then a run with no
    failure. The resumed steps must equal the uninterrupted run's bitwise
    (losses and the final parameters' bits). Returns the numbers, and the
    launch counts the workers reported (summed over every worker process
    of both runs) with the steps they ran."""
    gc.collect()
    torch.cuda.empty_cache()  # the worker shares the card with this process
    if TRAINER_STORAGE.exists():
        shutil.rmtree(TRAINER_STORAGE)
    TRAINER_STORAGE.mkdir(parents=True)
    free = shutil.disk_usage(TRAINER_STORAGE).free
    require(free > 1.5 * TRAINER_CKPT_BYTES,
            f"trainer: {free / 1e9:.1f} GB free under {TRAINER_STORAGE}, a checkpoint takes "
            f"{TRAINER_CKPT_BYTES / 1e9:.1f} GB")
    chaos_log = TRAINER_STORAGE / "chaos"
    try:
        # The gang's member is a runtime actor leasing the card from the
        # node agent.
        with on_runtime("trainer", num_cpus=8):
            killed, torn, latest_step = _trainer_run("killed", TRAINER_DIE_AFTER,
                                                     str(chaos_log))
            whole, _, _ = _trainer_run("whole", None)
        chaos_events = read_event_log(str(chaos_log))
    finally:
        shutil.rmtree(TRAINER_STORAGE, ignore_errors=True)
    require_member_leases("trainer", killed.attempts + whole.attempts)

    def steps(result):
        return [m["step"] for m in result.metrics_history]

    resumed_from = TRAINER_SAVE_AT + 1
    want = list(range(1, TRAINER_DIE_AFTER + 1)) + list(range(resumed_from, TRAINER_STEPS + 1))
    require(steps(killed) == want and steps(whole) == list(range(1, TRAINER_STEPS + 1)),
            f"trainer: steps {steps(killed)}, {steps(whole)}")
    require([a["ended_by"] for a in killed.attempts] == ["gang_died", "done"]
            and len(killed.resizes) == 1 and not whole.resizes,
            f"trainer: attempts {killed.attempts}, resizes {killed.resizes}")
    resumed = killed.metrics_history[TRAINER_DIE_AFTER:]
    uninterrupted = whole.metrics_history[TRAINER_SAVE_AT:]
    bitwise = ([m["loss"] for m in resumed] == [m["loss"] for m in uninterrupted]
               and resumed[-1]["digest"] == uninterrupted[-1]["digest"])
    # Each step sees fresh random tokens, so the loss need not fall; it
    # must be finite, and the parameters must move at the first step and
    # again by the last, so that the bitwise check compares real updates.
    losses = [m["loss"] for m in whole.metrics_history]
    first_step, last_step = whole.metrics_history[0], whole.metrics_history[-1]
    digests = [first_step["init_digest"], first_step["digest"], last_step["digest"]]
    moved = len({tuple(d) for d in digests}) == 3
    # Every worker process's last report holds its counts since its loop
    # began: sum them over the three processes (two attempts and the run
    # with no failure).
    last_of = {}
    for m in killed.metrics_history + whole.metrics_history:
        last_of[m["pid"]] = m
    lasts = list(last_of.values())
    require(len(lasts) == 3, f"trainer: reports came from {len(lasts)} worker processes")
    counts = {k: sum(m["counts"][k] for m in lasts) for k in lasts[0]["counts"]}
    routes = {k: {r: sum(m["routes"][k][r] for m in lasts) for r in ("wgmma", "mma_sync")}
              for k in lasts[0]["routes"]}
    ran = TRAINER_DIE_AFTER + (TRAINER_STEPS - TRAINER_SAVE_AT) + TRAINER_STEPS
    save = next(m for m in whole.metrics_history if "save_s" in m)
    first = killed.attempts[1]
    step_ms = 1e3 * statistics.median(m["step_s"] for m in whole.metrics_history[1:])
    result = dict(
        config=f"bench.py:133-138 at {TRAINER_LAYERS} layers", mesh=SHARDED_MESH,
        batch=SHARDED_BATCH, steps=TRAINER_STEPS,
        save_at=TRAINER_SAVE_AT, die_after=TRAINER_DIE_AFTER, bitwise=bitwise,
        losses=losses, resumed_losses=[m["loss"] for m in resumed],
        params_moved=moved, ckpt_bytes=save["ckpt_bytes"], save_s=save["save_s"],
        save_gb_per_s=save["ckpt_bytes"] / save["save_s"] / 1e9,
        restore_s=resumed[0]["restore_s"],
        restore_gb_per_s=save["ckpt_bytes"] / resumed[0]["restore_s"] / 1e9,
        restart_s=first["first_report"] - killed.attempts[0]["end"],
        # From the worker's exit: to the trainer's notice (the first
        # attempt's end, its gang shut down), and to the resumed run's first
        # report, split into the re-formed gang's formation, its session's
        # start and restore, and the first step.
        death_to_report_s=first["first_report"] - killed.died_at,
        death_to_notice_s=killed.attempts[0]["end"] - killed.died_at,
        restart_split_s={"formation": first["formed"] - first["start"],
                         "restore": resumed[0]["restore_s"],
                         "first_step": resumed[0]["step_s"]},
        timeline=_timeline(killed),
        gang_form_s=first["formed"] - first["start"],
        step_ms=step_ms, sharded_step_ms=sharded_step_ms,
        peak_gib=whole.metrics_history[-1]["peak_gib"], counts=counts, routes=routes,
        kernel_forwards=ran, kernel_backwards=ran, plain_forwards=0,
        torn_saves=torn, latest_committed_step=latest_step, chaos_events=chaos_events)
    log("trainer", **result)
    OBSERVABILITY["trainer"] = {"torn_saves": torn, "latest_committed_step": latest_step,
                                "chaos_events": chaos_events,
                                "resumed_from_step": resumed_from - 1, "bitwise": bitwise}
    # The kill landed inside a save: one torn directory, which verification
    # rejects, one fail-point event, and the restart resumed from the last
    # committed save, which stays the trial's latest.
    require(len(torn) == 1 and not torn[0][1],
            f"trainer: torn saves {torn} (one unverifiable directory expected)")
    require([(e["point"], e["method"], e["action"]) for e in chaos_events]
            == [("failpoint", "train.checkpoint.mid_save", "fail")],
            f"trainer: chaos events {chaos_events}")
    require(latest_step == TRAINER_SAVE_AT and resumed[0]["restore_s"] is not None,
            f"trainer: latest committed step {latest_step}, resumed from "
            f"{resumed[0]['restore_s']}")
    require(all(np.isfinite(losses)), f"trainer: losses {losses}")
    require(moved, f"trainer: parameter digests {digests} (before step 1, after it, after "
                   f"step {TRAINER_STEPS}) are not all different")
    require(bitwise, f"trainer: resumed steps {resumed} differ from the uninterrupted "
                     f"{uninterrupted}")
    return result


# ---------------------------------------------------------------- ranks as threads
class ThreadGroup:
    """``size`` ranks as threads of this process on the one card: the
    second implementation of the port's wire (``parallel._wire.Wire``),
    beside ``ProcessGroupWire``. The gang refuses more GPU workers than
    cards, and NCCL refuses two ranks on one device, so on one card the
    port's own ring attention, Ulysses attention and PipelineStageRunner
    run their sp 4 and pp 2 paths through this group.

    Each rank runs on a CUDA stream of its own. A message carries an event
    recorded on the sender's stream; the receiver's stream waits for it,
    the sender's tensor is recorded as in use on the receiver's stream (so
    the allocator keeps it until the copy ran), and the receiver copies it.
    Each rank's backward runs on its own thread
    (``set_multithreading_enabled(False)``): autograd's default is one
    worker thread per device for every backward, where a rank waiting in a
    collective would stop the other ranks' backwards. A rank's error aborts
    the group's barrier, so the others stop too."""

    def __init__(self, size: int, device="cuda", timeout_s: float = 600.0):
        self.size, self.device, self.timeout_s = size, torch.device(device), timeout_s
        self._barrier = threading.Barrier(size, timeout=timeout_s)
        self._slots = [None] * size
        self.queues = {(a, b): queue.Queue() for a in range(size) for b in range(size)
                        if a != b}

    def exchange(self, rank: int, value):
        """Every rank's ``value``, in rank order, on every rank."""
        self._slots[rank] = value
        self._barrier.wait()
        values = list(self._slots)
        self._barrier.wait()
        return values

    def run(self, fn) -> list:
        """fn(rank) on ``size`` threads; the results in rank order. Raises
        the first rank's error."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            streams = [torch.cuda.Stream(self.device) for _ in range(self.size)]
        results, errors = [None] * self.size, [None] * self.size

        def main(rank):
            try:
                with contextlib.ExitStack() as stack:
                    if cuda:
                        stack.enter_context(torch.cuda.stream(streams[rank]))
                    stack.enter_context(torch.autograd.set_multithreading_enabled(False))
                    results[rank] = fn(rank)
                    if cuda:
                        streams[rank].synchronize()
            except BaseException as exc:  # noqa: BLE001 - re-raised by run()
                errors[rank] = exc
                self._barrier.abort()

        threads = [threading.Thread(target=main, args=(r,), name=f"rank{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = ([e for e in errors if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)]
                 or [e for e in errors if e is not None])
        if first:
            raise first[0]
        if cuda:
            torch.cuda.synchronize()
        return results


class ThreadWire(_wire.Wire):
    """Rank ``rank``'s wire in a ThreadGroup."""

    def __init__(self, group: ThreadGroup, rank: int):
        self.group, self.rank, self.size = group, rank, group.size

    @staticmethod
    def _post(t: torch.Tensor):
        t = t.detach()
        event = None
        if t.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
        return t, event

    @staticmethod
    def _take(message, index=None) -> torch.Tensor:
        t, event = message
        if event is not None:
            stream = torch.cuda.current_stream(t.device)
            stream.wait_event(event)
            t.record_stream(stream)
        return (t if index is None else t[index]).clone()

    def shift(self, tensors, offset=1):
        values = self.group.exchange(self.rank, [self._post(t) for t in tensors])
        return [self._take(m) for m in values[(self.rank - offset) % self.size]]

    def all_to_all(self, x):
        values = self.group.exchange(self.rank, self._post(x))
        return torch.stack([self._take(values[j], self.rank) for j in range(self.size)])

    def all_reduce(self, x):
        values = self.group.exchange(self.rank, self._post(x))
        out = self._take(values[0])
        for j in range(1, self.size):
            out += self._take(values[j])
        return out

    def broadcast(self, x, src):
        return self._take(self.group.exchange(self.rank, self._post(x))[src])

    def send(self, x, dst):
        self.group.queues[(self.rank, dst)].put(self._post(x))

    def recv(self, like, src):
        out = self._take(self.group.queues[(src, self.rank)].get(timeout=self.group.timeout_s))
        require(tuple(out.shape) == tuple(like.shape) and out.dtype == like.dtype,
                f"thread wire: rank {self.rank} got {tuple(out.shape)} {out.dtype} from {src}, "
                f"expected {tuple(like.shape)} {like.dtype}")
        return out


class ThreadMesh:
    """One rank-thread's view of a mesh of thread ranks: ``wire(axis)`` is
    what the port's ``axis_wire`` asks of a mesh."""

    def __init__(self, **wires: ThreadWire):
        self._wires = wires

    def wire(self, axis: str) -> ThreadWire:
        return self._wires[axis]


# ---------------------------------------------------------------- phase 15
SP_RANKS = 4


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _sp_attention(kind: str, causal: bool, q, k, v, do, device) -> tuple:
    """The port's ring or Ulysses attention on SP_RANKS thread ranks, each
    holding its sequence shard: forward, then backward from do. Returns O,
    dQ, dK, dV gathered along the sequence, and the pass's wall ms."""
    maker = make_ring_attention if kind == "ring" else make_ulysses_attention
    group = ThreadGroup(SP_RANKS, device)
    seq = q.shape[2] // SP_RANKS

    def rank_fn(rank):
        attn = maker(ThreadMesh(sp=ThreadWire(group, rank)))
        cut = slice(rank * seq, (rank + 1) * seq)
        ql, kl, vl = (t[:, :, cut].detach().clone().requires_grad_(True) for t in (q, k, v))
        out = attn(ql, kl, vl, causal)
        out.backward(do[:, :, cut])
        return out.detach(), ql.grad, kl.grad, vl.grad

    _sync(device)
    start = time.perf_counter()
    results = group.run(rank_fn)
    ms = 1e3 * (time.perf_counter() - start)
    return [torch.cat([r[i] for r in results], dim=2) for i in range(4)], ms


def _sp_chunks(kind: str, causal: bool) -> int:
    """Flash launches (forward, or dQ, or dK/dV) of one pass over all ranks:
    ring attention runs n(n+1)/2 chunks causal, n^2 full; Ulysses one each."""
    n = SP_RANKS
    if kind == "ulysses":
        return n
    return n * (n + 1) // 2 if causal else n * n


def _sp_errs(got, whole, plain) -> dict:
    """O by max |a - b|; dQ, dK, dV by max |a - b| over b's largest."""
    names = ("o", "dq", "dk", "dv")
    errs = {}
    for label, ref in (("whole", whole), ("plain", plain)):
        for i, name in enumerate(names):
            errs[f"{name}_vs_{label}"] = (max_err(got[i], ref[i]) if i == 0
                                          else _bwd_err(got[i], ref[i], "rel_to_max"))
    return errs


def phase_sequence_parallel(config_kwargs=None, batch_size=TRAIN_BATCH, device="cuda") -> dict:
    """Ring and Ulysses attention, then the model with ring attention, on
    SP_RANKS thread ranks at bench.py's train config (bench.py:561-565).
    Returns the numbers and the launches the phase implies."""
    config = TransformerConfig(**(config_kwargs or TRAIN_CONFIG))
    b, h, s, d = batch_size, config.n_heads, config.max_seq, config.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=device).to(config.dtype)
                   for _ in range(4))
    want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "rmsnorm": 0, "rmsnorm_bwd": 0}

    def add(chunks, norms=0):
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            want[name] += chunks
        want["rmsnorm"] += norms
        want["rmsnorm_bwd"] += norms

    def timed(fn):
        _sync(device)
        start = time.perf_counter()
        out = fn()
        _sync(device)
        return out, 1e3 * (time.perf_counter() - start)

    def whole_pass(causal):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention(*leaves, causal=causal)
        out.backward(do)
        return [out.detach()] + [t.grad for t in leaves]

    # Each pass runs twice: the second is timed (wall, the ranks' threads
    # started and joined) and checked. The causal passes run again for
    # their device time: flash over the whole sequence by CUDA events on
    # its one stream, ring and Ulysses by torch.profiler, the kernels'
    # times summed over the ranks' streams.
    checks, times, device_ms = {}, {}, {}
    for causal in (True, False):
        mode = "causal" if causal else "full"
        whole_pass(causal)
        whole, times[f"whole_{mode}_ms"] = timed(lambda: whole_pass(causal))
        add(2)
        if causal and device == "cuda":  # one stream: CUDA events time the device
            device_ms["whole_causal"] = time_ms(lambda: whole_pass(True), iters=5, windows=3,
                                                warmup=1)["ms"]
            add(1 + 5 * 3)
        out_p = attention_reference(q, k, v, causal=causal)
        lse_p = flash_mod._lse_reference(q, k, causal=causal, scale=d ** -0.5)
        plain = [out_p] + list(flash_mod._flash_backward_reference(q, k, v, out_p, lse_p, do,
                                                                   causal=causal))
        del lse_p, out_p
        for kind in ("ring", "ulysses"):
            _sp_attention(kind, causal, q, k, v, do, device)
            got, times[f"{kind}_{mode}_ms"] = _sp_attention(kind, causal, q, k, v, do, device)
            add(2 * _sp_chunks(kind, causal))
            if causal and device == "cuda":
                device_ms[f"{kind}_causal"] = device_time(
                    lambda: _sp_attention(kind, True, q, k, v, do, device))["device_ms"]
                add(_sp_chunks(kind, True))
            errs = _sp_errs(got, whole, plain)
            checks[f"{kind}_{mode}"] = errs
            require(all(torch.isfinite(t).all() for t in got), f"sp {kind} {mode}: non-finite")
            bad = {n: e for n, e in errs.items()
                   if e >= (BF16_TOL if n.startswith("o_") else BWD_REL_TOL)}
            require(not bad, f"sp {kind} {mode}: {bad} (O bound {BF16_TOL} absolute, dQ/dK/dV "
                             f"{BWD_REL_TOL} of the largest)")
            del got
        del whole, plain
    del q, k, v, do
    if device == "cuda":
        torch.cuda.empty_cache()

    # The model with ring attention on the thread ranks, each holding its
    # quarter of every sequence, against the whole sequence through flash.
    params = init_params(config, seed=SEED, device=device)
    names, leaves = zip(*named_leaves(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    rng = np.random.default_rng(SEED + 16)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, (b, s + 1))).to(device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    _grads(params, leaves, inputs, targets, config)
    (loss_whole, grads_whole), whole_ms = timed(
        lambda: _grads(params, leaves, inputs, targets, config))
    norms = 2 * config.n_layers + 1
    add(2 * config.n_layers, 2 * norms)
    seq = s // SP_RANKS

    def ring_pass():
        group = ThreadGroup(SP_RANKS, device)
        return group.run(functools.partial(rank_fn, group))

    def rank_fn(group, rank):
        mesh = ThreadMesh(sp=ThreadWire(group, rank))
        ring = dataclasses.replace(config, attention=make_ring_attention(mesh))
        cut = slice(rank * seq, (rank + 1) * seq)
        logits = forward(params, inputs[:, cut], ring, sequence_positions(mesh, b, seq,
                                                                          device=device))
        loss = logits_loss(logits, targets[:, cut])
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    ring_pass()
    ranks, ring_ms = timed(ring_pass)
    add(2 * config.n_layers * _sp_chunks("ring", True), 2 * SP_RANKS * norms)
    # Each rank's loss is the mean over its quarter of the tokens.
    loss_ring = sum(r[0] for r in ranks) / SP_RANKS
    grad_errs = {}
    for i, name in enumerate(names):
        total = sum(r[1][i].float() for r in ranks) / SP_RANKS
        grad_errs[name] = _rel_frobenius(total, grads_whole[i])
    del ranks, grads_whole
    worst = max(grad_errs, key=grad_errs.get)
    model = dict(loss_ring=loss_ring, loss_whole=loss_whole,
                 loss_err=abs(loss_ring - loss_whole), loss_tol=TRAIN_LOSS_TOL,
                 grad_rel_frobenius=grad_errs, worst_leaf=worst, grad_tol=TRAIN_GRAD_REL_TOL,
                 ring_fwd_bwd_ms=ring_ms, whole_fwd_bwd_ms=whole_ms)
    result = dict(config="bench.py:561-565", sp=SP_RANKS, batch=b, seq=s, heads=h,
                  head_dim=d, dtype=str(config.dtype), ring_tokens_per_rank=seq,
                  ulysses_heads_per_rank=h // SP_RANKS, attention=checks,
                  attention_wall_ms=times, attention_device_ms=device_ms, model=model,
                  want=want)
    log("sequence_parallel", **result)
    require(model["loss_err"] < TRAIN_LOSS_TOL, f"sp model: loss {loss_ring} vs {loss_whole}")
    require(grad_errs[worst] < TRAIN_GRAD_REL_TOL,
            f"sp model: {worst} gradient ring vs whole {grad_errs[worst]}")
    del params, leaves
    if device == "cuda":
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 16
PP_STAGES, PP_VIRTUAL, PP_MICRO, PP_BATCH, PP_STEPS = 2, 2, 8, 16, 3


def _pp_runner(rank, group, chunks, config):
    """Rank ``rank``'s PipelineStageRunner over ``group``'s thread wire."""
    ctx = session_mod.TrainContext(world_size=PP_STAGES, world_rank=rank, pipeline={
        "num_stages": PP_STAGES, "microbatches": PP_MICRO, "virtual": PP_VIRTUAL,
        "attempt": 0, "stage": rank, "stage_rank": 0})

    def make_fn(vs):
        def fn(p, a):
            return stage_forward(p, a, config, first=(vs == 0), last=False)
        return fn

    def last_fn(p, a, micro):
        return logits_loss(stage_forward(p, a, config, first=False, last=True), micro["y"])

    mine = [c * PP_STAGES + rank for c in range(PP_VIRTUAL)]
    return PipelineStageRunner(
        ctx=ctx, stage_fn=[make_fn(vs) for vs in mine], last_stage_fn=last_fn,
        params=[chunks[vs] for vs in mine], optimizer=make_optimizer,
        activation_like=lambda micro: torch.empty((*micro["y"].shape, config.dim),
                                                  dtype=config.dtype, device="meta"),
        microbatch_fn=microbatch_slicer, wire=ThreadWire(group, rank))


def _fused_microbatched_step(params, leaves, optimizer, batch, config) -> torch.Tensor:
    """bench.py's _bench_pp reference in one process: the loss's gradient
    summed over the microbatches in order, over their count, then one
    optimizer step; returns the mean microbatch loss."""
    micro = PP_BATCH // PP_MICRO
    acc, losses = None, []
    for m in range(PP_MICRO):
        cut = slice(m * micro, (m + 1) * micro)
        loss = loss_fn(params, batch["x"][cut], batch["y"][cut], config)
        grads = torch.autograd.grad(loss, leaves)
        acc = list(grads) if acc is None else [a + g for a, g in zip(acc, grads)]
        losses.append(loss.detach())
    for leaf, grad in zip(leaves, acc):
        leaf.grad = grad / PP_MICRO
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return torch.stack(losses).float().mean()


def phase_pipeline(config_kwargs=None, batch_size=PP_BATCH, device="cuda") -> dict:
    """Two PipelineStageRunners (S=2, v=2, M=8) on two thread ranks at
    bench.py's sharded config, as bench.py's _bench_pp runs it, held against
    the fused microbatched step from the same parameters and batch; then
    timed steps of each. Returns the numbers and the launches the phase
    implies."""
    config = TransformerConfig(**(config_kwargs or SHARDED_CONFIG))
    scheds = [schedule_interleaved_1f1b(PP_STAGES, PP_MICRO, r, PP_VIRTUAL)
              for r in range(PP_STAGES)]
    validate_schedule(scheds, PP_VIRTUAL)
    check_message_order(scheds, PP_VIRTUAL)
    rng = np.random.default_rng(SEED + 17)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size,
                                           (batch_size, config.max_seq + 1))).to(device)
    batch = {"x": tokens[:, :-1], "y": tokens[:, 1:]}
    fused = init_params(config, seed=SEED, device=device)
    fused_names, fused_leaves = zip(*named_leaves(fused))
    fused_opt = make_optimizer(fused)
    chunks = [tree_map(lambda t: t.detach().clone(), tree)
              for tree in partition_stages(fused, config, PP_STAGES * PP_VIRTUAL)]
    group = ThreadGroup(PP_STAGES, device)
    runners = [_pp_runner(r, group, chunks, config) for r in range(PP_STAGES)]

    def pipeline_step():
        return group.run(lambda rank: runners[rank].train_step(batch))

    # One step of each from the same parameters and batch.
    pp_losses = pipeline_step()
    fused_loss = float(_fused_microbatched_step(fused, fused_leaves, fused_opt, batch, config))
    merged = merge_stages(chunks)
    got = dict(named_leaves(merged))
    bitwise = (pp_losses[0] == pp_losses[1] == fused_loss
               and all(torch.equal(got[n], leaf) for n, leaf in zip(fused_names, fused_leaves)))
    update_err = {}
    if not bitwise:
        init = dict(named_leaves(init_params(config, seed=SEED, device=device)))
        for n, leaf in zip(fused_names, fused_leaves):
            ref_update = leaf.detach().float() - init[n].float()
            update_err[n] = float((got[n].float() - leaf.detach().float()).abs().max()
                                  / ref_update.abs().max().clamp_min(1e-30))
        del init
    del merged, got
    worst = max(update_err, key=update_err.get) if update_err else None
    check = dict(bitwise=bitwise, pipeline_losses=pp_losses, fused_loss=fused_loss,
                 loss_err=abs(pp_losses[0] - fused_loss), loss_tol=SHARDED_LOSS_TOL,
                 worst_leaf=worst, worst_update_err=update_err.get(worst),
                 update_tol=SHARDED_UPDATE_TOL, held="bitwise" if bitwise else "tolerance")
    log("pipeline_check", **check)
    require(pp_losses[0] == pp_losses[1], f"pipeline: the ranks report {pp_losses}")
    if not bitwise:
        require(check["loss_err"] < SHARDED_LOSS_TOL and update_err[worst] < SHARDED_UPDATE_TOL,
                f"pipeline: against the fused step: loss {check['loss_err']}, {worst} update "
                f"{update_err[worst]}")

    # Timed steps of each.
    stats = []
    _sync(device)
    start = time.perf_counter()
    losses = []
    for _ in range(PP_STEPS):
        losses.append(pipeline_step()[0])
        stats.append([dict(r.stats) for r in runners])
    _sync(device)
    pp_s = (time.perf_counter() - start) / PP_STEPS
    start = time.perf_counter()
    fused_losses = [float(_fused_microbatched_step(fused, fused_leaves, fused_opt, batch, config))
                    for _ in range(PP_STEPS)]
    _sync(device)
    fused_s = (time.perf_counter() - start) / PP_STEPS
    require(all(np.isfinite(losses)) and losses[-1] < pp_losses[0],
            f"pipeline: loss did not fall ({pp_losses[0]} -> {losses})")
    per_rank = [{k: statistics.mean(step[r][k] for step in stats) for k in stats[0][r]}
                for r in range(PP_STAGES)]
    bubble = [p["pp_bubble"] / p["step"] for p in per_rank]

    # Launches: a chunk of L/(S v) layers; every chunk but the last runs its
    # forward twice a microbatch (once, then again in the backward), the
    # last once with the loss; every layer one backward.
    layers, steps = config.n_layers, 1 + PP_STEPS
    last_chunk = layers // (PP_STAGES * PP_VIRTUAL)
    layer_fwds = PP_MICRO * (2 * (layers - last_chunk) + last_chunk)
    per_step = {"flash_attention_fwd": layer_fwds, "flash_attention_bwd_dq": PP_MICRO * layers,
                "flash_attention_bwd_dkv": PP_MICRO * layers,
                "rmsnorm": 2 * layer_fwds + PP_MICRO, "rmsnorm_bwd": PP_MICRO * (2 * layers + 1)}
    fused_per_step = _expected(layers, kernel_forwards=PP_MICRO, kernel_backwards=PP_MICRO)
    want = {k: steps * (per_step[k] + fused_per_step[k]) for k in per_step}
    tokens_per_step = batch_size * config.max_seq
    result = dict(
        config="bench.py:133-138 (_bench_pp: bench.py:203-300)", stages=PP_STAGES,
        virtual=PP_VIRTUAL, microbatches=PP_MICRO, batch=batch_size, seq=config.max_seq,
        layers=layers, dtype=str(config.dtype), check=check, losses=losses,
        step_ms=1e3 * pp_s, tokens_per_s=tokens_per_step / pp_s,
        fused_step_ms=1e3 * fused_s, fused_tokens_per_s=tokens_per_step / fused_s,
        fused_losses=fused_losses, per_rank_s=per_rank, pp_bubble_share=bubble,
        bubble_fraction=bubble_fraction(PP_STAGES, PP_MICRO, PP_VIRTUAL),
        per_step_launches=per_step, want=want)
    log("pipeline", **result)
    del runners, chunks, fused, fused_leaves, fused_opt
    if device == "cuda":
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 17
# Expert parallelism: phase 11's MoE model (llama2_7b(moe=MoEConfig(),
# n_layers=2), 8 experts, bf16) on EP_RANKS thread ranks of the card, each
# holding 2 experts' shard of w_gate, w_up and w_down and its own copy of
# every other leaf, against the one-rank model on the same weights and
# batch. Routing is pinned as phase 11 pins it: the ep ranks replay the
# one-rank pass's dispatch with their own gates (the sum over ep rounds the
# MoE output otherwise than one einsum does, which moves layer 1's router
# inputs by bf16 ulps). The loss is held to EP_LOSS_REL_TOL relative (the
# two passes differ by the bf16 roundings of the ep sum only), each
# gradient leaf to BWD_REL_TOL by relative Frobenius norm (the experts'
# leaves as the ranks' shards put together), as phase 15 holds its model.
EP_RANKS = 4
EP_STEPS = 3
EP_LOSS_REL_TOL = 1e-5
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _ep_shard(params: dict, rank: int) -> dict:
    """Rank's own copy of every leaf, the experts' leaves cut to its share
    of the expert dim; each leaf requires grad."""
    def cut(name, leaf):
        if name in EXPERT_LEAVES:
            per = leaf.shape[1] // EP_RANKS
            leaf = leaf[:, rank * per:(rank + 1) * per]
        return leaf.detach().clone().requires_grad_(True)

    return {"embed": cut("embed", params["embed"]),
            "layers": {n: cut(n, leaf) for n, leaf in params["layers"].items()},
            "final_norm": cut("final_norm", params["final_norm"]),
            "lm_head": cut("lm_head", params["lm_head"])}


def _ep_context(group: ThreadGroup, rank: int) -> tp_mod.TPContext:
    return tp_mod.TPContext(group=None, rank=0, size=1, ep=EP_RANKS,
                            ep_wire=ThreadWire(group, rank), ep_rank=rank)


def phase_expert_parallel(config=None, batch_size=MOE_TRAIN_BATCH, device="cuda") -> dict:
    """The MoE model on EP_RANKS thread ranks against one rank: one step's
    loss and gradients with the routing pinned, then timed AdamW steps of
    each. Returns the numbers and the launches the phase implies."""
    config = config or moe_config(MOE_TRAIN_LAYERS)
    seq = config.max_seq if device == "cpu" else MOE_TRAIN_SEQ
    params = init_params(config, seed=SEED, device=device)
    names, leaves = zip(*named_leaves(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    rng = np.random.default_rng(SEED + 19)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, (batch_size, seq + 1))).to(device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    passes = {"kernel_forwards": 0, "kernel_backwards": 0}

    def count(ranks=1):
        passes["kernel_forwards"] += ranks
        passes["kernel_backwards"] += ranks

    # The one-rank pass records each layer's dispatch; the ep ranks replay it.
    combine_fn = transformer_mod._moe_combine
    dispatch, held = [], []
    layer_of = threading.local()

    def probs(ht, router):
        return torch.softmax(ht.float() @ router.float(), dim=-1)

    def record(ht, router, moe, ctx=None):
        combine = combine_fn(ht, router, moe, ctx)
        dispatch.append(combine > 0)
        held.append(bool(torch.equal(combine, dispatch[-1] * probs(ht, router)[:, :, None])))
        return combine

    def replay(ht, router, moe, ctx=None):
        i = getattr(layer_of, "i", 0)
        layer_of.i = i + 1
        return dispatch[i] * probs(ht, router)[:, :, None]

    shards = [_ep_shard(params, r) for r in range(EP_RANKS)]
    group = ThreadGroup(EP_RANKS, device)

    def rank_grads(rank):
        with tp_mod.tensor_parallel(_ep_context(group, rank)):
            loss = loss_fn(shards[rank], inputs, targets, config)
        own = [leaf for _, leaf in named_leaves(shards[rank])]
        return float(loss.detach()), torch.autograd.grad(loss, own)

    try:
        transformer_mod._moe_combine = record
        loss_one, grads_one = _grads(params, leaves, inputs, targets, config)
        count()
        transformer_mod._moe_combine = replay
        ranks = group.run(rank_grads)
        count(EP_RANKS)
    finally:
        transformer_mod._moe_combine = combine_fn
    require(all(held) and len(held) == config.n_layers,
            f"ep: combine is not dispatch * probs: {held}")
    losses_ep = [r[0] for r in ranks]
    grad_errs, rank_spread = {}, {}
    for i, name in enumerate(names):
        leaf = name.split(".")[-1]
        if leaf in EXPERT_LEAVES and name.startswith("layers."):
            got = torch.cat([r[1][i] for r in ranks], dim=1)
        else:  # whole on every rank, and equal
            got = ranks[0][1][i]
            rank_spread[name] = max(float((r[1][i].float() - got.float()).abs().max())
                                    for r in ranks[1:])
        grad_errs[name] = _rel_frobenius(got, grads_one[i])
    del ranks, grads_one, dispatch
    worst = max(grad_errs, key=grad_errs.get)
    loss_rel = abs(losses_ep[0] - loss_one) / abs(loss_one)
    check = dict(loss_one_rank=loss_one, losses_ep=losses_ep, loss_rel_err=loss_rel,
                 loss_tol=EP_LOSS_REL_TOL, grad_rel_frobenius=grad_errs,
                 grad_tol=BWD_REL_TOL, worst_leaf=worst,
                 replicated_grads_max_spread_over_ranks=max(rank_spread.values()))
    log("expert_parallel_check", **check)
    require(len(set(losses_ep)) == 1, f"ep: the ranks' losses differ: {losses_ep}")
    require(max(rank_spread.values()) == 0.0,
            f"ep: a replicated leaf's gradient differs across the ep ranks: {rank_spread}")
    require(loss_rel < EP_LOSS_REL_TOL, f"ep: loss {losses_ep[0]} vs one rank {loss_one}")
    require(grad_errs[worst] < BWD_REL_TOL,
            f"ep: {worst} gradient ep vs one rank {grad_errs[worst]} >= {BWD_REL_TOL}")
    _sync(device)

    # Timed AdamW steps on one batch: one rank (train_step), then the ep
    # ranks, each with its own optimizer over its leaves; a warm-up first.
    optimizer = make_optimizer(params)
    one_first = float(train_step(params, optimizer, tokens, config))
    count()
    _sync(device)
    start = time.perf_counter()
    one_losses = [float(train_step(params, optimizer, tokens, config)) for _ in range(EP_STEPS)]
    _sync(device)
    one_ms = 1e3 * (time.perf_counter() - start) / EP_STEPS
    count(EP_STEPS)
    del optimizer, params, leaves
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    optimizers = [make_optimizer(shard) for shard in shards]

    def rank_step(rank):
        with tp_mod.tensor_parallel(_ep_context(group, rank)):
            loss = loss_fn(shards[rank], inputs, targets, config)
        loss.backward()
        optimizers[rank].step()
        optimizers[rank].zero_grad(set_to_none=True)
        return float(loss.detach())

    ep_first = group.run(rank_step)[0]
    count(EP_RANKS)
    _sync(device)
    start = time.perf_counter()
    ep_losses = [group.run(rank_step)[0] for _ in range(EP_STEPS)]
    _sync(device)
    ep_ms = 1e3 * (time.perf_counter() - start) / EP_STEPS
    count(EP_RANKS * EP_STEPS)
    prof = device_time(lambda: group.run(rank_step), top=8) if device == "cuda" else None
    if prof is not None:
        count(EP_RANKS)
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    require(all(np.isfinite(ep_losses + one_losses)), f"ep: losses {ep_losses}, {one_losses}")
    require(ep_losses[-1] < ep_first and one_losses[-1] < one_first,
            f"ep: loss did not fall (ep {ep_first} -> {ep_losses}, one rank {one_first} -> "
            f"{one_losses})")
    step_tokens = batch_size * seq
    result = dict(
        config="llama2_7b(moe=MoEConfig(), n_layers=2)", ep=EP_RANKS,
        experts=config.moe.num_experts, experts_per_rank=config.moe.num_experts // EP_RANKS,
        batch=batch_size, seq=seq, dtype=str(config.dtype), check=check,
        ep_first_loss=ep_first, ep_losses=ep_losses, one_rank_losses=one_losses,
        ep_step_ms=ep_ms, ep_tokens_per_s=step_tokens / (ep_ms / 1e3),
        one_rank_step_ms=one_ms, one_rank_tokens_per_s=step_tokens / (one_ms / 1e3),
        ep_peak_gib=peak, ep_collective_calls=dict(tp_mod.calls),
        ep_step_device_ms_summed_over_ranks=prof and prof["device_ms"],
        ep_step_top=prof and prof["top"], **passes)
    log("expert_parallel", **result)
    del shards, optimizers
    if device == "cuda":
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 18
# LoRA: release/train_llama_lora.py --full (BASELINE config 5):
# TransformerConfig.llama2_7b(max_seq=2048) in bf16 at full width and
# depth, batch 1 x 2048, rank 8 on wq and wv, AdamW(1e-4) on the adapters
# alone (lines 46-47, 54, 91-102). The adapters' gradients through the
# kernels are held against the same step through plain attention and the
# norm's plain backward, as phase 7 holds the model's (TRAIN_GRAD_REL_TOL).
LORA_BATCH, LORA_SEQ, LORA_STEPS = 1, 2048, 3
LORA_PARAMS_RANK_8 = 4_194_304  # 32 layers x 2 targets x (4096 x 8 + 8 x 4096)


def _lora_launches(layers: int, forwards: int, steps: int, plain_forwards: int) -> dict:
    """The launches of LoRA passes: a flash forward a layer and forward,
    and a dQ and a dK/dV a layer and backward (in layer 0 q and v take the
    adapters' gradient, k none); 2 norms a layer and the final one in every
    forward, and in every backward the norms but layer 0's first, whose
    input is the frozen embedding and whose weight is frozen."""
    kernel_forwards = forwards + steps
    return {"flash_attention_fwd": layers * kernel_forwards,
            "flash_attention_bwd_dq": layers * steps,
            "flash_attention_bwd_dkv": layers * steps,
            "rmsnorm": (2 * layers + 1) * (kernel_forwards + plain_forwards),
            "rmsnorm_bwd": 2 * layers * steps}


def phase_lora(config=None, batch_size=LORA_BATCH, device="cuda") -> dict:
    """LoRA fine-tuning steps at Llama-2-7B size: identity at init, AdamW
    steps whose loss falls, then the adapters' gradients against the plain
    versions. Returns the numbers and the launches the phase implies."""
    from ray_tpu_torch.models.lora import (
        LoRAConfig, init_lora, lora_forward, lora_loss, num_lora_params,
    )

    config = config or TransformerConfig.llama2_7b(max_seq=LORA_SEQ)
    seq = config.max_seq
    lcfg = LoRAConfig(rank=8)
    start = time.perf_counter()
    params = init_params(config, seed=SEED, device=device)
    adapters = init_lora(config, lcfg, torch.Generator(device=device).manual_seed(SEED + 18))
    _sync(device)
    init_s = time.perf_counter() - start
    n_lora = num_lora_params(adapters)
    if config.dim == 4096 and config.n_layers == 32:
        require(n_lora == LORA_PARAMS_RANK_8, f"lora: {n_lora} adapter parameters")
    rng = np.random.default_rng(SEED + 18)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, (batch_size, seq + 1))).to(device)
    counts = {"forwards": 0, "steps": 0, "plain_forwards": 0}

    # B = 0: the adapted model is the base model, bitwise.
    with torch.inference_mode():
        identity = torch.equal(lora_forward(params, adapters, tokens[:, :-1], config, lcfg),
                               forward(params, tokens[:, :-1], config))
    counts["forwards"] += 2
    require(identity, "lora: at init lora_forward differs from forward")

    optimizer = make_optimizer(adapters, lr=1e-4)
    require(not any(leaf.requires_grad for _, leaf in named_leaves(params)),
            "lora: a base leaf requires grad")

    def step():
        loss = lora_loss(params, adapters, tokens, config, lcfg)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    first = float(step())
    _sync(device)
    start = time.perf_counter()
    losses = [float(step()) for _ in range(LORA_STEPS)]
    _sync(device)
    step_ms = 1e3 * (time.perf_counter() - start) / LORA_STEPS
    counts["steps"] += 1 + LORA_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    prof = device_time(lambda: step(), top=8) if device == "cuda" else None
    if prof is not None:
        counts["steps"] += 1
    require(all(np.isfinite(losses)) and losses[-1] < first,
            f"lora: loss did not fall ({first} -> {losses})")

    # The adapters' gradients (B no longer 0) through the kernels and
    # through plain attention and the norm's plain backward.
    names, leaves = zip(*named_leaves(adapters))

    def grads(cfg):
        loss = lora_loss(params, adapters, tokens, cfg, lcfg)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    loss_k, grads_k = grads(config)
    counts["steps"] += 1
    kernel_backward = rmsnorm_mod.rmsnorm_backward
    rmsnorm_mod.rmsnorm_backward = rmsnorm_mod._rmsnorm_backward
    try:
        loss_p, grads_p = grads(dataclasses.replace(config, attention="reference"))
    finally:
        rmsnorm_mod.rmsnorm_backward = kernel_backward
    counts["plain_forwards"] += 1
    grad_errs = {n: _rel_frobenius(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    worst = max(grad_errs, key=grad_errs.get)
    del grads_k, grads_p
    step_tokens = batch_size * seq
    result = dict(
        config="TransformerConfig.llama2_7b(max_seq=2048) (release/train_llama_lora.py --full)",
        layers=config.n_layers, dim=config.dim, dtype=str(config.dtype), batch=batch_size,
        seq=seq, rank=lcfg.rank, targets=list(lcfg.targets), lora_params=n_lora,
        base_params=num_params(params), init_s=init_s, identity_at_init=identity,
        first_loss=first, losses=losses, step_ms=step_ms,
        tokens_per_s=step_tokens / (step_ms / 1e3), peak_gib=peak,
        step_device_ms=prof and prof["device_ms"],
        device_idle_share=prof and 1.0 - prof["device_ms"] / step_ms,
        step_top=prof and prof["top"], loss_kernel=loss_k, loss_plain=loss_p,
        loss_err=abs(loss_k - loss_p), loss_tol=TRAIN_LOSS_TOL, grad_rel_frobenius=grad_errs,
        grad_tol=TRAIN_GRAD_REL_TOL, per_step_launches=_lora_launches(config.n_layers, 0, 1, 0),
        want=_lora_launches(config.n_layers, **counts), **counts)
    log("lora", **result)
    require(result["loss_err"] < TRAIN_LOSS_TOL, f"lora: kernel vs plain loss {loss_k}, {loss_p}")
    require(grad_errs[worst] < TRAIN_GRAD_REL_TOL,
            f"lora: {worst} gradient kernel vs plain {grad_errs[worst]} >= {TRAIN_GRAD_REL_TOL}")
    del params, adapters, optimizer, leaves
    if device == "cuda":
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 19
# The CNN and the ResNet (models/cnn.py; BASELINE configs 1 and 3): no
# Pallas kernel stands behind them (their convolutions are XLA's in the
# reference, cuDNN's here), so the path launches none of the port's
# kernels. f32 with TF32 off; the first step's logits on the card against
# the same step on the CPU from the same parameters and batch, max |card -
# CPU| over max(1, max |CPU|) within CNN_LOGITS_TOL (f32 sums in other
# orders through up to 17 layers: the f32 forward bound of the parity
# tests, 2e-5, times ten); then Adam steps whose loss falls, and img/s from
# the median step, each step ended by a synchronize: a CNN step takes 2-3
# ms, where one stall of the host moves a short window's mean tenfold.
CNN_BATCH, RESNET_BATCH, CNN_STEPS = 64, 128, 20
CNN_LOGITS_TOL = 2e-4


def _tree_to(tree, device):
    """A tree of dicts and lists of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device, copy=True)


def _cnn_run(name, config, init, loss_of, forward_of, batch_size, device) -> dict:
    params = init(config, SEED, "cpu")
    rng = np.random.default_rng(SEED + 20)
    size, channels = config.image_size, config.in_channels
    images = torch.from_numpy(rng.standard_normal((batch_size, size, size, channels))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, config.num_classes, batch_size))
    with torch.no_grad():
        cpu_logits = forward_of(params, images, config)
    card = _tree_to(params, device)
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(card)]
    optimizer = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    images, labels = images.to(device), labels.to(device)
    with torch.no_grad():
        logits = forward_of(card, images, config)
    err = float((logits.cpu() - cpu_logits).abs().max() / max(1.0, float(cpu_logits.abs().max())))

    def step():
        loss, acc = loss_of(card, images, labels, config)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach(), acc

    first = float(step()[0])
    losses, times = [], []
    for _ in range(CNN_STEPS):
        _sync(device)
        start = time.perf_counter()
        losses.append(float(step()[0]))
        times.append(time.perf_counter() - start)
    step_s = statistics.median(times)
    out = dict(batch=batch_size, image=[size, size, channels],
               params=sum(leaf.numel() for leaf in leaves), logits_err=err,
               logits_tol=CNN_LOGITS_TOL, max_abs_logit=float(cpu_logits.abs().max()),
               first_loss=first, losses=losses, step_ms=1e3 * step_s,
               step_ms_mean=1e3 * statistics.mean(times), step_ms_max=1e3 * max(times),
               img_per_s=batch_size / step_s)
    require(err < CNN_LOGITS_TOL, f"{name}: logits on the card vs the CPU {err}")
    require(all(np.isfinite(losses)) and losses[-1] < first,
            f"{name}: loss did not fall ({first} -> {losses})")
    return out


def phase_cnn(device="cuda") -> dict:
    from ray_tpu_torch.models.cnn import (
        CNNConfig, ResNetConfig, cnn_forward, cnn_loss, init_cnn, init_resnet, resnet_forward,
        resnet_loss,
    )

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        result = {
            "cnn": _cnn_run("cnn", CNNConfig(), init_cnn, cnn_loss, cnn_forward, CNN_BATCH,
                            device),
            "resnet": _cnn_run("resnet", ResNetConfig(), init_resnet, resnet_loss,
                               resnet_forward, RESNET_BATCH, device),
        }
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    result.update(cnn_config="CNNConfig() (release/train_fashion_mnist.py: batch 64, Adam 1e-3)",
                  resnet_config="ResNetConfig(): ResNet-18 layout, width 64, 32 x 32 x 3 "
                                "(release/tune_asha_resnet.py's model at full depth), Adam 1e-3",
                  dtype="float32, TF32 off")
    log("cnn", **result)
    return result


# ---------------------------------------------------------------- phase 20
# RLlib (ray_tpu_torch/rllib/; BASELINE config 2 and the north star's
# PPO-Atari). The learner owns the card and the rollouts stay on the host, as
# in the reference; its nets are MLPs, VALID convolutions and an LSTM (XLA's
# in the reference, cuBLAS and cuDNN here), so no kernel of the port runs.
# gymnasium does not import on the H100 machine (`python3 -c "import
# gymnasium"` there: ModuleNotFoundError, checked on that machine before
# this phase was written), and nothing may be installed: the phase
# runs the learner half, which needs no gymnasium, and the env runners'
# half (env-steps/s, BASELINE config 2's CartPole to 100) waits for the
# package.
RL_GYMNASIUM = False
# The card's update against the CPU's, from the same parameters on the same
# minibatch, f32 with TF32 off: the loss and each metric by |card - CPU| over
# max(1, |CPU|), each parameter leaf after the update by ||card - CPU|| /
# ||CPU|| (Frobenius). cuDNN's and oneDNN's f32 convolutions and the GEMMs
# sum in other orders, which moves the gradients by f32 rounding (about
# 1e-7 relative; reordering the minibatch's rows on the CPU alone moves the
# leaves by at most 2e-7), and Adam's first step turns each gradient into
# about lr times its sign. A dropped or doubled term, a wrong layout or a
# wrong clip is off by order 1.
RL_METRIC_TOL = 1e-4
RL_PARAM_REL_TOL = 1e-4
RL_BOOTSTRAP_CALLS = 50


class _Box:
    """The shape and dtype of a gymnasium Box, which the modules read, and
    its bounds where a module reads them (SAC's action box)."""

    def __init__(self, shape, dtype, low=None, high=None):
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)
        if low is not None:
            self.low, self.high = np.full(shape, low, dtype), np.full(shape, high, dtype)


class _Discrete:
    def __init__(self, n):
        self.n = n


RL_CASES = {
    "ppo_atari": dict(
        obs=_Box((84, 84, 4), np.uint8), act=_Discrete(6), model={}, minibatch=128,
        config=dict(lr=3e-4),
        source="release/rllib_ppo_atari_shaped.py::_throughput: ConvModule "
               "[[32,8,4],[64,4,2],[64,3,1]] + 512 on uint8 [84, 84, 4], Discrete(6), "
               "minibatch 128, lr 3e-4"),
    "ppo_cartpole": dict(
        obs=_Box((4,), np.float32), act=_Discrete(2), model={"fcnet_hiddens": (64, 64)},
        minibatch=256, config=dict(lr=3e-4, entropy_coeff=0.01),
        source="release/rllib_ppo_cartpole.py (BASELINE config 2): MLPModule (64, 64), "
               "Discrete(2), minibatch 256, lr 3e-4, entropy 0.01"),
}


def _rl_batch(case: dict, seed: int):
    rng = np.random.default_rng(seed)
    rows, space = case["minibatch"], case["obs"]
    if space.dtype == np.uint8:
        obs = rng.integers(0, 256, (rows, *space.shape), dtype=np.uint8)
    else:
        obs = rng.standard_normal((rows, *space.shape)).astype(np.float32)
    return SampleBatch({
        OBS: obs, ACTIONS: rng.integers(0, case["act"].n, rows),
        ACTION_LOGP: np.log(rng.uniform(0.1, 0.9, rows)).astype(np.float32),
        ADVANTAGES: rng.standard_normal(rows).astype(np.float32),
        VALUE_TARGETS: rng.standard_normal(rows).astype(np.float32),
    })


def _rl_layers(module, towers=("pi", "vf")) -> list:
    """(multiply-adds a row, whether its input needs a gradient) of each
    layer a forward of ``towers`` runs (ConvModule: the shared trunk and both
    heads)."""
    layers = []
    if isinstance(module, ConvModule):
        h, w, c = module.obs_shape
        for i, (out, k, s) in enumerate(module.filters):
            h, w = (h - k) // s + 1, (w - k) // s + 1
            layers.append((h * w * out * k * k * c, i > 0))
            c = out
        sizes = (module.conv_out_dim, *module.post_hiddens)
        layers += [(a * b, True) for a, b in zip(sizes[:-1], sizes[1:])]
        layers += [(sizes[-1] * module.num_outputs, True), (sizes[-1], True)]
        return layers
    for tower in towers:
        outputs = module.num_outputs if tower == "pi" else 1
        sizes = (module.obs_dim, *module.hiddens, outputs)
        layers += [(a * b, i > 0) for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))]
    return layers


def _pass_flops(layers, rows: int, backward: bool = True, weights: bool = True) -> int:
    """Operations of one pass over ``layers``: two per multiply-add, the
    forward's products once, the backward's once for dX (where the input
    needs a gradient) and once for dW (``weights``)."""
    total = 0
    for macs, dx in layers:
        products = 1 + (backward and dx) + (backward and weights)
        total += 2 * macs * rows * products
    return total


def _rl_update_flops(module, rows: int) -> int:
    """Operations of one PPO-style update's forward and backward over both
    towers. The Adam step and the elementwise work are left out."""
    return _pass_flops(_rl_layers(module), rows)


def _sac_update_flops(module, rows: int, cql_n: int = 0) -> int:
    """Operations of one SAC (CQL) update's products, pass by pass: the
    critic target (pi on next_obs, two target towers: forward only), both
    critics on the data (forward and backward), the actor (pi forward and
    backward, both towers forward and dX only: their leaves are detached);
    CQL adds pi on n x B rows (forward only) and each critic on 2n x B rows
    (forward and backward)."""
    pi = [(a * b, i > 0) for i, (a, b) in enumerate(zip(
        (module.obs_dim, *module.hiddens), (*module.hiddens, 2 * module.act_dim)))]
    q_sizes = (module.obs_dim + module.act_dim, *module.hiddens, 1)
    q = [(a * b, i > 0) for i, (a, b) in enumerate(zip(q_sizes[:-1], q_sizes[1:]))]
    q_dx = [(macs, True) for macs, _ in q]  # the actor's a_pi takes a gradient
    total = (_pass_flops(pi, rows, backward=False) + 2 * _pass_flops(q, rows, backward=False)
             + 2 * _pass_flops(q, rows) + _pass_flops(pi, rows)
             + 2 * _pass_flops(q_dx, rows, weights=False))
    if cql_n:
        total += (_pass_flops(pi, cql_n * rows, backward=False)
                  + 2 * _pass_flops(q, 2 * cql_n * rows))
    return total


def _rl_run(name: str, case: dict, device) -> dict:
    config = {"grad_clip": 40.0, "clip_param": 0.2, "vf_clip_param": 10.0, "vf_loss_coeff": 0.5,
              "entropy_coeff": 0.0, **case["config"]}
    spec = RLModuleSpec(model_config=case["model"])
    cpu, card = (PPOLearner(spec.build(case["obs"], case["act"], device=where), config,
                            seed=SEED, device=where) for where in ("cpu", device))
    card.set_weights(cpu.get_weights())
    minibatch = _rl_batch(case, SEED + 30)
    cpu_metrics, card_metrics = cpu.update(minibatch), card.update(minibatch)
    metric_errs = {k: abs(card_metrics[k] - v) / max(1.0, abs(v)) for k, v in cpu_metrics.items()}
    leaf_errs = {n: float((a.detach().cpu() - b.detach()).norm() / b.detach().norm())
                 for (n, a), (_, b) in zip(named_leaves(card.params), named_leaves(cpu.params))}
    on_card = all(leaf.device.type == torch.device(device).type
                  for _, leaf in named_leaves(card.params))
    require(on_card, f"{name}: the learner's parameters are not on {device}")
    require(all(np.isfinite(list(card_metrics.values()))), f"{name}: {card_metrics}")
    require(max(metric_errs.values()) < RL_METRIC_TOL,
            f"{name}: metrics on the card vs the CPU {metric_errs}")
    require(max(leaf_errs.values()) < RL_PARAM_REL_TOL,
            f"{name}: parameters after the update on the card vs the CPU {leaf_errs}")

    rows = case["minibatch"]
    flops = _rl_update_flops(card.module, rows)
    bound_ms = flops / PEAK_OPS_PER_S[torch.float32] * 1e3
    update = functools.partial(card.update, minibatch)
    timed = time_ms(update)
    walls = []
    for _ in range(20):
        start = time.perf_counter()
        update()
        walls.append(1e3 * (time.perf_counter() - start))
    prof = device_time(update)
    require(prof["device_ops"] > 0, f"{name}: the profiled update ran nothing on the card")
    vf = value_function(card.module, card.params)
    row = np.ascontiguousarray(minibatch[OBS][:1])
    vf(row)
    calls = []
    for _ in range(RL_BOOTSTRAP_CALLS):
        start = time.perf_counter()
        value = vf(row)
        calls.append(1e3 * (time.perf_counter() - start))
    require(value.shape == (1,) and np.isfinite(value).all(), f"{name}: bootstrap value {value}")
    return dict(
        source=case["source"], minibatch=rows,
        params=sum(leaf.numel() for _, leaf in named_leaves(card.params)),
        metrics=card_metrics, metric_errs=metric_errs, metric_tol=RL_METRIC_TOL,
        leaf_rel_errs=leaf_errs, leaf_rel_tol=RL_PARAM_REL_TOL,
        update_ms=timed["ms"], update_ms_range=timed["range"],
        update_wall_ms=statistics.median(walls), update_device_ms=prof["device_ms"],
        update_device_ops=prof["device_ops"],
        update_device_idle_share=1.0 - prof["device_ms"] / timed["ms"],
        update_top=prof["top"], update_flops=flops, update_bound_ms=bound_ms,
        update_bound_by="operations (f32 outside the tensor cores)",
        bootstrap_call_ms=statistics.median(calls),
        bootstrap_call_ms_range=[min(calls), max(calls)],
    )


def _rl_learner_half(card, seed: int) -> dict:
    """The learner's half of one iteration of release/rllib_ppo_atari_shaped.
    py's configuration (2 runners x 4 envs x 32 steps = 256 rows, minibatch
    128, 2 epochs), on fragments made here in the runners' env-major layout:
    GAE (numpy, with its V(next_obs) bootstrap calls on the card, one for
    each of the 8 env streams cut at the fragment's end), the minibatch
    epochs in default_rng(iteration) order, and the weights fetched for the
    sync. The sampling half needs gymnasium (RL_GYMNASIUM)."""
    rng = np.random.default_rng(seed)
    rows, streams = 256, 8
    frames = rng.integers(0, 256, (rows + 1, 84, 84, 4), dtype=np.uint8)
    fragments = SampleBatch({
        OBS: frames[:-1], NEXT_OBS: frames[1:], ACTIONS: rng.integers(0, 6, rows),
        REWARDS: np.ones(rows, np.float32), TERMINATEDS: np.zeros(rows, bool),
        TRUNCATEDS: np.zeros(rows, bool),
        ACTION_LOGP: np.log(rng.uniform(0.1, 0.3, rows)).astype(np.float32),
        VF_PREDS: rng.standard_normal(rows).astype(np.float32),
        EPS_ID: np.repeat(np.arange(streams), rows // streams),
    })
    vf = value_function(card.module, card.params)
    calls = []

    def counted(obs):
        calls.append(1)
        return vf(obs)

    start = time.perf_counter()
    fragments = GeneralAdvantageEstimation(gamma=0.99, lambda_=0.95)(fragments,
                                                                     value_fn=counted)
    gae_s = time.perf_counter() - start
    order = np.random.default_rng(0)
    start = time.perf_counter()
    updates = 0
    for _ in range(2):
        for mb in fragments.minibatches(128, order):
            card.update(mb)
            updates += 1
    learn_s = time.perf_counter() - start
    start = time.perf_counter()
    weights = card.get_weights()
    sync_s = time.perf_counter() - start
    require(len(calls) == streams and updates == 4, f"learner half: {len(calls)} bootstrap "
            f"calls, {updates} updates")
    return dict(rows=rows, gae_ms=1e3 * gae_s, bootstrap_calls=len(calls),
                learner_updates=updates, learner_ms=1e3 * learn_s,
                weights_fetch_ms=1e3 * sync_s,
                weights_mb=sum(w.nbytes for _, w in named_leaves(weights)) / 1e6,
                sampling="not run: gymnasium is not installed on this machine")


def phase_rllib(device="cuda") -> dict:
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    try:
        result = {name: _rl_run(name, case, device) for name, case in RL_CASES.items()}
        module = RLModuleSpec().build(RL_CASES["ppo_atari"]["obs"], RL_CASES["ppo_atari"]["act"],
                                      device=device)
        config = {"lr": 3e-4, "grad_clip": 40.0, "clip_param": 0.2, "vf_clip_param": 10.0,
                  "vf_loss_coeff": 0.5, "entropy_coeff": 0.0}
        card = PPOLearner(module, config, seed=SEED, device=device)
        _rl_learner_half(card, SEED + 31)  # warm-up
        result["ppo_atari_iteration_learner_half"] = _rl_learner_half(card, SEED + 32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    result.update(dtype="float32, TF32 off", peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  gymnasium=RL_GYMNASIUM,
                  env_runners="not run: gymnasium is not installed on this machine")
    log("rllib", **result)
    return result


# ---------------------------------------------------------------- phase 21
# RLlib's second slice on the card: IMPALA and APPO (V-trace), DQN, SAC and
# CQL (replay, noise drawn on the learner's device), BC and MARWIL
# (offline), and multi-agent PPO (a learner a module id). Each case runs at
# the widths the repo configures for that algorithm, uncut, f32 with TF32
# off, on a seeded synthetic batch; the card's learner is held against a
# CPU learner from the same parameters on the same batch with the same
# noise, to RL_METRIC_TOL and RL_PARAM_REL_TOL (target trees included). The
# runners and envs wait for gymnasium (RL_GYMNASIUM), as in phase 20.
# Adam normalises each gradient component by its own size, so a component
# whose gradient is rounding noise moves by about lr whatever its size
# (ROADMAP Queue C item 11), and two learners whose sums run in other orders
# can land up to 2 lr apart there. So the phase holds each update's gradient,
# leaf by leaf, by relative Frobenius norm (RL_PARAM_REL_TOL): a wrong loss,
# layout or stop-gradient cannot pass that. It holds the leaves after the
# updates by relative Frobenius norm (RL_PARAM_REL_TOL) over the components
# whose gradients the card and the CPU agree on to 1 / RL_GRAD_AGREE of
# their size at every update, and the rest within Adam's own bound,
# RL_ADAM_STEP lr a step for each learner (|m_hat / sqrt(v_hat)| <=
# (1 - b1) / sqrt(1 - b2), 3.16 at Adam's betas; 1 at the first step).
RL_GRAD_AGREE = 1e3
RL_ADAM_STEP = 3.2
OFFPOLICY_CASES = {
    "impala_atari": dict(
        algo="impala", obs=_Box((84, 84, 4), np.uint8), act=_Discrete(6), model={},
        rows=200, envs=4, updates=1,
        config=dict(lr=5e-4, vf_loss_coeff=0.5, entropy_coeff=0.01, clip_rho_threshold=1.0,
                    clip_c_threshold=1.0),
        source="IMPALAConfig() defaults; ConvModule [[32,8,4],[64,4,2],[64,3,1]] + 512 on "
               "uint8 [84, 84, 4], Discrete(6); one fragment of 4 envs x 50 steps "
               "(rollout_fragment_length 50)"),
    "impala_cartpole": dict(
        algo="impala", obs=_Box((4,), np.float32), act=_Discrete(2),
        model={"fcnet_hiddens": (64, 64)}, rows=256, envs=4, updates=1,
        config=dict(lr=1e-3, vf_loss_coeff=0.5, entropy_coeff=0.01, clip_rho_threshold=1.0,
                    clip_c_threshold=1.0),
        source="tests/test_rllib.py:270-285: MLP (64, 64), 4 envs x 64 steps, lr 1e-3, "
               "entropy 0.01"),
    "appo_atari": dict(
        algo="appo", obs=_Box((84, 84, 4), np.uint8), act=_Discrete(6), model={},
        rows=200, envs=4, updates=5,
        config=dict(lr=5e-4, vf_loss_coeff=0.5, entropy_coeff=0.01, clip_rho_threshold=1.0,
                    clip_c_threshold=1.0, clip_param=0.3, use_kl_loss=True, kl_coeff=0.2,
                    kl_target=0.01, target_network_update_freq=4),
        source="APPOConfig() defaults on impala_atari's net and fragment; 5 consecutive "
               "updates: the target syncs after the 4th, the KL coefficient adapts"),
    "dqn_cartpole": dict(
        algo="dqn", obs=_Box((4,), np.float32), act=_Discrete(2),
        model={"fcnet_hiddens": (64, 64)}, rows=64, updates=1,
        config=dict(lr=1e-3, double_q=True),
        source="tests/test_rllib.py:300-318: MLP (64, 64) with its target tree, batch 64, "
               "double-Q, lr 1e-3"),
    "sac_pendulum": dict(
        algo="sac", obs=_Box((3,), np.float32), act=_Box((1,), np.float32, -2.0, 2.0), model={},
        rows=256, updates=1,
        config=dict(lr=3e-4, tau=0.005, target_entropy="auto", initial_alpha=1.0),
        source="SACConfig() defaults: SACModule (256, 256) on Pendulum's spaces (obs 3, "
               "Box(1) in [-2, 2]), batch 256"),
    "cql_pendulum": dict(
        algo="cql", obs=_Box((3,), np.float32), act=_Box((1,), np.float32, -2.0, 2.0), model={},
        rows=256, updates=1,
        config=dict(lr=3e-4, tau=0.005, target_entropy="auto", initial_alpha=1.0,
                    cql_alpha=5.0, cql_n_actions=10),
        source="CQLConfig() defaults (n 10, alpha 5.0) on sac_pendulum's net, batch 256"),
    "bc_cartpole": dict(
        algo="bc", obs=_Box((4,), np.float32), act=_Discrete(2),
        model={"fcnet_hiddens": (64, 64)}, rows=256, updates=1, config=dict(lr=1e-3),
        source="tests/test_rllib_extras.py:599-630: MLP (64, 64), batch 256, lr 1e-3"),
    "marwil_cartpole": dict(
        algo="marwil", obs=_Box((4,), np.float32), act=_Discrete(2),
        model={"fcnet_hiddens": (64, 64)}, rows=256, updates=1,
        config=dict(lr=1e-3, beta=1.0, vf_coeff=1.0, advantage_clip=10.0),
        source="tests/test_rllib_extras.py:649-700: MLP (64, 64), batch 256, lr 1e-3, "
               "beta 1.0"),
    "multi_agent_ppo": dict(
        algo="multi_agent_ppo", obs=_Box((4,), np.float32), act=_Discrete(2),
        model={"fcnet_hiddens": (64, 64)}, rows=256, updates=1,
        config=dict(lr=3e-4, entropy_coeff=0.01, clip_param=0.2, vf_clip_param=10.0,
                    vf_loss_coeff=0.5),
        source="tests/test_rllib_extras.py:376-409: two PPO MLP modules (64, 64) on "
               "MultiAgentCartPole's spaces, minibatch 256 each, through "
               "MultiAgentLearnerGroup.update_module"),
}


def _offpolicy_learner(case: dict, device):
    """(learner, module) of the case's algorithm on ``device``, seed SEED."""
    from ray_tpu_torch.rllib.algorithms.appo.appo import APPOLearner
    from ray_tpu_torch.rllib.algorithms.bc.bc import BCLearner
    from ray_tpu_torch.rllib.algorithms.cql.cql import CQLLearner
    from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQNLearner
    from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALALearner
    from ray_tpu_torch.rllib.algorithms.marwil.marwil import MARWILLearner
    from ray_tpu_torch.rllib.algorithms.sac.sac import SACLearner, SACModule
    from ray_tpu_torch.rllib.core.learner import MultiAgentLearnerGroup
    from ray_tpu_torch.rllib.core.multi_rl_module import MultiRLModuleSpec

    config = {"grad_clip": 40.0, "gamma": 0.99, **case["config"]}
    if case["algo"] == "multi_agent_ppo":
        spec = MultiRLModuleSpec({m: RLModuleSpec(model_config=case["model"])
                                  for m in ("p0", "p1")})
        spaces = ({m: case["obs"] for m in ("p0", "p1")}, {m: case["act"] for m in ("p0", "p1")})
        return MultiAgentLearnerGroup(PPOLearner, spec, *spaces, config, device=device)
    cls = {"impala": IMPALALearner, "appo": APPOLearner, "dqn": DQNLearner, "sac": SACLearner,
           "cql": CQLLearner, "bc": BCLearner, "marwil": MARWILLearner}[case["algo"]]
    spec = (RLModuleSpec(SACModule, case["model"]) if case["algo"] in ("sac", "cql")
            else RLModuleSpec(model_config=case["model"]))
    return cls(spec.build(case["obs"], case["act"], device=device), config, seed=SEED,
               device=device)


def _offpolicy_batch(case: dict, seed: int) -> SampleBatch:
    """A seeded batch in the layout the case's algorithm takes: env-major
    fragments with dones inside (IMPALA, APPO), replayed transitions (DQN,
    SAC, CQL), offline rows with returns-to-go (BC, MARWIL)."""
    from ray_tpu_torch.rllib.algorithms.marwil.marwil import RETURNS

    rng = np.random.default_rng(seed)
    rows, space = case["rows"], case["obs"]
    if space.dtype == np.uint8:
        frames = rng.integers(0, 256, (rows + 1, *space.shape), dtype=np.uint8)
        obs, next_obs = frames[:-1], frames[1:]
    else:
        obs = rng.standard_normal((rows + 1, *space.shape)).astype(np.float32)
        obs, next_obs = obs[:-1], obs[1:]
    if isinstance(case["act"], _Discrete):
        actions = rng.integers(0, case["act"].n, rows)
    else:
        actions = rng.uniform(-2, 2, (rows, *case["act"].shape)).astype(np.float32)
    batch = {OBS: obs, ACTIONS: actions, REWARDS: rng.standard_normal(rows).astype(np.float32),
             TERMINATEDS: rng.random(rows) < 0.02, TRUNCATEDS: np.zeros(rows, bool)}
    if case["algo"] in ("impala", "appo"):
        batch[NEXT_OBS] = next_obs
        batch[ACTION_LOGP] = np.log(rng.uniform(0.1, 0.9, rows)).astype(np.float32)
        batch["bootstrap_value"] = np.full(rows, rng.standard_normal(), np.float32)
        batch[EPS_ID] = np.repeat(np.arange(case["envs"]), rows // case["envs"])
    elif case["algo"] in ("dqn", "sac", "cql"):
        batch[NEXT_OBS] = next_obs
        batch["batch_indexes"] = rng.integers(0, 50_000, rows)
    elif case["algo"] in ("bc", "marwil"):
        batch[RETURNS] = (10 * rng.random(rows)).astype(np.float32)
    elif case["algo"] == "multi_agent_ppo":
        batch[ACTION_LOGP] = np.log(rng.uniform(0.1, 0.9, rows)).astype(np.float32)
        batch[ADVANTAGES] = rng.standard_normal(rows).astype(np.float32)
        batch[VALUE_TARGETS] = rng.standard_normal(rows).astype(np.float32)
    return SampleBatch(batch)


def _sac_noise(case: dict, seed: int) -> dict:
    """One draw of the SAC (CQL) step's noise, handed to both learners."""
    rng = np.random.default_rng(seed)
    shape = (case["rows"], *case["act"].shape)
    noise = {"actor": rng.standard_normal(shape), "next": rng.standard_normal(shape)}
    n = case["config"].get("cql_n_actions")
    if case["algo"] == "cql":
        noise["rand_u"] = rng.uniform(-1, 1, (n, *shape))
        noise["pi"] = rng.standard_normal((n, *shape))
    return {k: v.astype(np.float32) for k, v in noise.items()}


def _named(tree, grads=None, prefix: str = "") -> dict:
    """{name: tensor} over a tree's leaves (or ``grads``, a list in the
    tree's ``named_leaves`` order), detached, on the CPU, in f64."""
    leaves = named_leaves(tree)
    values = grads if grads is not None else [leaf for _, leaf in named_leaves(tree)]
    return {f"{prefix}{n}": torch.as_tensor(v).detach().cpu().double()
            for (n, _), v in zip(leaves, values, strict=True)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||; ||a|| where b is all zero (a leaf the loss does
    not reach)."""
    norm = float(b.norm())
    return float((a - b).norm()) / norm if norm > 0 else float(a.norm())


def _offpolicy_grads(learner, case: dict, batches: list, noise, step: int) -> dict:
    """{leaf name: gradient} of the case's loss on batch ``step``."""
    if case["algo"] == "multi_agent_ppo":
        out = {}
        for m in ("p0", "p1"):
            lr = learner.learners[m]
            out.update(_named(lr.params, lr.compute_gradients(batches[step][m]), f"{m}."))
        return out
    if case["algo"] in ("sac", "cql"):
        grads = learner.compute_gradients(batches[step], noise=noise[step])
    else:
        grads = learner.compute_gradients(batches[step])
    return _named(learner.params, grads)


def _offpolicy_params(learner, case: dict) -> dict:
    """{leaf name: value} of the learner's parameters and target trees."""
    if case["algo"] == "multi_agent_ppo":
        out = {}
        for m in ("p0", "p1"):
            out.update(_named(learner.learners[m].params, prefix=f"{m}."))
        return out
    out = _named(learner.params)
    if getattr(learner, "target_params", None) is not None:
        out.update(_named(learner.target_params, prefix="target."))
    return out


def _offpolicy_update(learner, case: dict, batches: list, noise: dict | None, step: int):
    """One update of the case's learner; its metrics (floats)."""
    if case["algo"] == "multi_agent_ppo":
        return {f"{m}/{k}": v for m in ("p0", "p1")
                for k, v in learner.update_module(m, batches[step][m]).items()}
    if case["algo"] in ("sac", "cql"):
        return learner.update(batches[step], noise=noise[step] if noise else None)
    return learner.update(batches[step])


@contextlib.contextmanager
def _relu_inputs(learner, recorded: list):
    """Records the input of every ReLU the learner's modules run (the
    modules call torch.relu, ConvModule through its ``activation``)."""
    relu = torch.relu

    def spy(x):
        recorded.append(x.detach().cpu())
        return relu(x)

    module = getattr(learner, "module", None)
    swap = module is not None and getattr(module, "activation", None) is relu
    torch.relu = spy
    if swap:
        module.activation = spy
    try:
        yield
    finally:
        torch.relu = relu
        if swap:
            module.activation = relu


def _drop_relu_flips(cpu, card, case: dict, batches: list, noise, step: int) -> int:
    """Leaves out of batch ``step`` (and its noise) the rows where the card
    and the CPU put an input of a ReLU on different sides of zero within the
    loss's passes; returns how many. There the ReLU's derivative jumps, and
    f32 rounding (about 1e-7 of the layer's scale) decides the side: one
    such row moved impala_atari's conv.0 and conv.1 gradients by 2.5e-3
    (relative Frobenius) in a probe on the H100. The card's update is timed
    on the whole batch."""
    dropped = 0
    for _ in range(3):
        seen = ([], [])
        for learner, rec in zip((cpu, card), seen):
            with _relu_inputs(learner, rec):
                _offpolicy_grads(learner, case, batches, noise, step)
        rows = len(batches[step])
        flipped = np.zeros(rows, bool)
        for a, b in zip(*seen, strict=True):
            differs = ((a > 0) != (b > 0)).reshape(a.shape[0], -1).any(1).numpy()
            np.logical_or.at(flipped, np.nonzero(differs)[0] % rows, True)
        if not flipped.any():
            return dropped
        keep = ~flipped
        dropped += int(flipped.sum())
        batches[step] = SampleBatch({k: v[keep] for k, v in batches[step].items()})
        if noise:
            noise[step] = {k: v[keep] if v.ndim == 2 else v[:, keep]
                           for k, v in noise[step].items()}
    raise AssertionError(f"ReLU sides still differ after dropping {dropped} rows")


def _offpolicy_run(name: str, case: dict, device) -> dict:
    from ray_tpu_torch.rllib.core.learner import _numpy, _tensors

    cpu, card = (_offpolicy_learner(case, where) for where in ("cpu", device))
    card.set_weights(cpu.get_weights())
    if getattr(cpu, "target_params", None) is not None:
        card.target_params = _tensors(_numpy(cpu.target_params), device)
    steps = case["updates"]
    if case["algo"] == "multi_agent_ppo":
        batches = [{m: _offpolicy_batch(case, SEED + 40 + 2 * s + i)
                    for i, m in enumerate(("p0", "p1"))} for s in range(steps)]
    else:
        batches = [_offpolicy_batch(case, SEED + 40 + s) for s in range(steps)]
    noise = ([_sac_noise(case, SEED + 60 + s) for s in range(steps)]
             if case["algo"] in ("sac", "cql") else None)
    timed_batch = batches[0]
    metric_errs, grad_errs, kl_coeffs, held, dropped = {}, {}, [], None, []
    for step in range(steps):
        if case["algo"] != "multi_agent_ppo":  # its MLPs are tanh
            dropped.append(_drop_relu_flips(cpu, card, case, batches, noise, step))
        cpu_grads = _offpolicy_grads(cpu, case, batches, noise, step)
        card_grads = _offpolicy_grads(card, case, batches, noise, step)
        for n, g in cpu_grads.items():
            grad_errs[f"{step}/{n}"] = _rel(card_grads[n], g)
        agree = {n: g.abs() >= RL_GRAD_AGREE * (card_grads[n] - g).abs()
                 for n, g in cpu_grads.items()}
        held = agree if held is None else {n: held[n] & agree[n] for n in held}
        cpu_metrics = _offpolicy_update(cpu, case, batches, noise, step)
        card_metrics = _offpolicy_update(card, case, batches, noise, step)
        if "td_abs" in cpu_metrics:  # DQN's per-sample |TD|, held as the metrics are
            want, got = cpu_metrics.pop("td_abs"), card_metrics.pop("td_abs")
            metric_errs[f"{step}/td_abs"] = float(np.max(np.abs(got - want))
                                                  / max(1.0, float(np.max(np.abs(want)))))
        require(sorted(card_metrics) == sorted(cpu_metrics), f"{name}: metric names differ")
        for k, v in cpu_metrics.items():
            metric_errs[f"{step}/{k}"] = abs(card_metrics[k] - v) / max(1.0, abs(v))
        if "kl_coeff" in cpu_metrics:
            kl_coeffs.append(card_metrics["kl_coeff"])
            require(card_metrics["kl_coeff"] == cpu_metrics["kl_coeff"],
                    f"{name}: KL coefficient {card_metrics['kl_coeff']} on the card, "
                    f"{cpu_metrics['kl_coeff']} on the CPU")
    cpu_params, card_params = _offpolicy_params(cpu, case), _offpolicy_params(card, case)
    lr, leaf_errs, floor_dev, floor_count = case["config"]["lr"], {}, 0.0, 0
    for n, b in cpu_params.items():
        mask = held[n.removeprefix("target.")]
        a = card_params[n]
        leaf_errs[n] = _rel(a[mask], b[mask])
        if (~mask).any():
            floor_count += int((~mask).sum())
            floor_dev = max(floor_dev, float((a - b)[~mask].abs().max()))
    leaves = ([leaf for lr_ in card.learners.values() for _, leaf in named_leaves(lr_.params)]
              if case["algo"] == "multi_agent_ppo"
              else [leaf for _, leaf in named_leaves(card.params)])
    require(all(leaf.device.type == torch.device(device).type for leaf in leaves),
            f"{name}: the learner's parameters are not on {device}")
    require(all(np.isfinite(list(card_metrics.values()))), f"{name}: {card_metrics}")
    require(max(metric_errs.values()) < RL_METRIC_TOL,
            f"{name}: metrics on the card vs the CPU {metric_errs}")
    require(max(grad_errs.values()) < RL_PARAM_REL_TOL,
            f"{name}: gradients on the card vs the CPU {grad_errs}")
    require(max(leaf_errs.values()) < RL_PARAM_REL_TOL,
            f"{name}: parameters after the updates on the card vs the CPU {leaf_errs}")
    require(floor_dev <= 2 * RL_ADAM_STEP * lr * steps,
            f"{name}: components at Adam's noise floor moved {floor_dev} apart")
    if case["algo"] == "appo":
        require(card._updates_since_sync == cpu._updates_since_sync == steps % 4,
                f"{name}: target syncs {card._updates_since_sync}")

    # Timing: the card's update on the case's first batch (SAC and CQL draw
    # their noise on the card, as training does).
    rows = case["rows"]
    update = functools.partial(_offpolicy_update, card, case, [timed_batch], None, 0)
    timed = time_ms(update)
    walls = []
    for _ in range(20):
        start = time.perf_counter()
        update()
        walls.append(1e3 * (time.perf_counter() - start))
    prof = device_time(update)
    require(prof["device_ops"] > 0, f"{name}: the profiled update ran nothing on the card")
    if case["algo"] in ("sac", "cql"):
        flops = _sac_update_flops(card.module, rows, case["config"].get("cql_n_actions", 0)
                                  if case["algo"] == "cql" else 0)
    elif case["algo"] == "dqn":
        pi = _rl_layers(card.module, towers=("pi",))
        flops = _pass_flops(pi, rows) + 2 * _pass_flops(pi, rows, backward=False)
    elif case["algo"] == "multi_agent_ppo":
        flops = sum(_rl_update_flops(lr.module, rows) for lr in card.learners.values())
    else:
        flops = _rl_update_flops(card.module, rows)
        if case["algo"] == "appo":  # the target network's forward
            flops += _pass_flops(_rl_layers(card.module), rows, backward=False)
    bound_ms = flops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return dict(
        source=case["source"], rows=rows, updates_checked=steps,
        params=sum(leaf.numel() for leaf in leaves),
        metrics=card_metrics, metric_errs_max=max(metric_errs.values()),
        metric_tol=RL_METRIC_TOL, grad_rel_errs_max=max(grad_errs.values()),
        grad_rel_err_worst=max(grad_errs, key=grad_errs.get),
        leaf_rel_errs_max=max(leaf_errs.values()),
        leaf_rel_err_worst=max(leaf_errs, key=leaf_errs.get), leaf_rel_tol=RL_PARAM_REL_TOL,
        noise_floor_components=floor_count, noise_floor_max_dev=floor_dev,
        relu_flip_rows_dropped=dropped or None,
        noise_floor_bound=2 * RL_ADAM_STEP * lr * steps,
        kl_coeffs=kl_coeffs or None,
        update_ms=timed["ms"], update_ms_range=timed["range"],
        update_wall_ms=statistics.median(walls), update_device_ms=prof["device_ms"],
        update_device_ops=prof["device_ops"],
        update_device_idle_share=1.0 - prof["device_ms"] / timed["ms"],
        update_top=prof["top"], update_flops=flops, update_bound_ms=bound_ms,
        update_bound_by="operations (f32 outside the tensor cores)",
    )


def _impala_learner_half(seed: int, device) -> dict:
    """IMPALA's learner half on the Atari-shaped fragment (4 envs x 50 steps):
    the bootstrap call (V(next_obs) of the fragment's last row on the card),
    V-trace alone on the host (f32 numpy, 200 rows), V-trace's whole round
    trip inside the update (logp and values to the host, the recursion, the
    targets back), and the update; V-trace's share of the update."""
    from ray_tpu_torch.rllib.algorithms.impala.impala import vtrace

    case = OFFPOLICY_CASES["impala_atari"]
    card = _offpolicy_learner(case, device)
    fragment = _offpolicy_batch(case, seed)
    vf = value_function(card.module, card.params)
    row = np.ascontiguousarray(fragment[NEXT_OBS][-1:])
    vf(row)
    calls = []
    for _ in range(RL_BOOTSTRAP_CALLS):
        start = time.perf_counter()
        value = vf(row)
        calls.append(1e3 * (time.perf_counter() - start))
    fragment["bootstrap_value"] = np.full(len(fragment), value[0], np.float32)
    batch = card._device_batch(fragment)
    with torch.no_grad():
        logp, _, values = card.module.action_logp(card.params, batch[OBS], batch[ACTIONS])
    host = [np.asarray(fragment[ACTION_LOGP]), logp.cpu().numpy(), fragment[REWARDS],
            values.cpu().numpy(), value[0],
            (0.99 * (1.0 - (fragment[TERMINATEDS] | fragment[TRUNCATEDS]))).astype(np.float32)]
    host_ms, trip_ms, update_ms = [], [], []
    for _ in range(20):
        start = time.perf_counter()
        vtrace(*host)
        host_ms.append(1e3 * (time.perf_counter() - start))
        start = time.perf_counter()
        card._vtrace(batch, logp, values)
        trip_ms.append(1e3 * (time.perf_counter() - start))
        start = time.perf_counter()
        card.update(fragment)
        update_ms.append(1e3 * (time.perf_counter() - start))
    update = statistics.median(update_ms)
    return dict(rows=len(fragment), bootstrap_call_ms=statistics.median(calls),
                vtrace_host_ms=statistics.median(host_ms),
                vtrace_round_trip_ms=statistics.median(trip_ms),
                update_wall_ms=update,
                vtrace_share_of_update=statistics.median(trip_ms) / update,
                sampling="not run: gymnasium is not installed on this machine")


def phase_rllib_offpolicy(device="cuda") -> dict:
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    try:
        result = {name: _offpolicy_run(name, case, device)
                  for name, case in OFFPOLICY_CASES.items()}
        _impala_learner_half(SEED + 70, device)  # warm-up
        result["impala_atari_learner_half"] = _impala_learner_half(SEED + 71, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    result.update(dtype="float32, TF32 off", peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  gymnasium=RL_GYMNASIUM,
                  env_runners="not run: gymnasium is not installed on this machine")
    for name in OFFPOLICY_CASES:
        log("rllib_offpolicy", case=name, **result[name])
    log("rllib_offpolicy", impala_atari_learner_half=result["impala_atari_learner_half"],
        dtype=result["dtype"], peak_gib=result["peak_gib"], env_runners=result["env_runners"])
    return result


# ---------------------------------------------------------------- phase 22
# The step profiler: phase 7's cell through the split step under a
# StepRecorder and a capture, then a TorchTrainer capture, then a one-rank
# hier group. PROFILE_STEPS steps, the capture armed for PROFILE_CAPTURE
# steps from PROFILE_START. The boundary before the window starts the
# trace (CUPTI's start-up) and the last one exports it, each timed apart;
# the capture's cost on a step is read from its second step against the
# uncaptured ones after the warm-up.
PROFILE_STEPS, PROFILE_START, PROFILE_CAPTURE = 5, 2, 2
PROFILE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_profiles"
PROFILE_SCOPES = ("fwd", "bwd", "grad_sync", "opt")
# Each wrapper's kernels by a part of their names, and the scope of the
# split step its launches belong to: the forward's flash and norms under
# fwd, their backwards under bwd (the train config has no remat, so bwd
# recomputes no forward).
TRACED_KERNELS = {
    "flash_attention_fwd": ("flash_fwd", "fwd"),
    "flash_attention_bwd_dq": ("flash_bwd_dq", "bwd"),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv", "bwd"),
    "rmsnorm": ("rmsnorm_fwd", "fwd"),
    "rmsnorm_bwd": ("rmsnorm_bwd", "bwd"),
}
# AdamW's kernels (torch's multi-tensor AdamW over the leaves).
ADAMW_KERNEL = "multi_tensor_apply"
# The device work a scope's time breaks into, by kernel name.
KERNEL_CLASSES = (("flash", ("flash_",)), ("rmsnorm", ("rmsnorm_",)),
                  ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
                  ("adamw", (ADAMW_KERNEL,)), ("nccl", ("nccl",)),
                  ("copy", ("copy_kernel", "catarray", "memcpy", "memset")))


class _ProfileCtx:
    """What a StepRecorder reads of a train context, for the in-process
    capture of phase 22 (a): rank 0 on this process's card."""

    world_rank, node_id, device = 0, "chip_smoke", "cuda:0"


def _kernel_class(name: str) -> str:
    low = name.lower()
    for cls, parts in KERNEL_CLASSES:
        if any(part in low for part in parts):
            return cls
    return "elementwise"


def _trace_events(trace_dir: str) -> list:
    with open(os.path.join(trace_dir, profiler_mod.TRACE_FILE)) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _attribute(events: list) -> dict:
    """Puts every device operation (kernel, copy, set) of a torch.profiler
    trace under the ProfilerStep window and the step_annotation scope that
    launched it: the launch is the runtime call with the operation's
    correlation id, and its host time lies inside one scope on the host's
    timeline, whatever thread made it (autograd's device thread launches the
    backward). An operation with no launch record falls back to its own
    device time window, which lies inside its scope because each scope ends
    with the device synchronized. Returns the operations with their step and
    scope, and how many each method placed."""
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    steps = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("ProfilerStep#")), key=lambda e: e["ts"])
    scopes = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] in PROFILE_SCOPES]

    def within(ts, windows):
        for w in windows:
            if w["ts"] <= ts <= w["ts"] + w["dur"]:
                return w
        return None

    ops, methods = [], {"launch": 0, "window": 0, "none": 0}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            at, method = launch["ts"], "launch"
        else:
            at, method = e["ts"], "window"
        scope, step = within(at, scopes), within(at, steps)
        if scope is None and step is None:
            method = "none"
        methods[method] += 1
        ops.append({"name": e["name"], "dur_ms": e["dur"] / 1e3,
                    "scope": scope["name"] if scope else None,
                    "step": step["name"] if step else None})
    return {"ops": ops, "methods": methods, "steps": [s["name"] for s in steps],
            "scopes": [s["name"] for s in scopes]}


def _scope_breakdown(ops: list, top: int = 8) -> dict:
    """Per scope: device ms, operations, ms by kernel class, and the `top`
    operations by time with their counts."""
    out = {}
    for scope in PROFILE_SCOPES + (None,):
        mine = [op for op in ops if op["scope"] == scope and op["step"] is not None]
        by_name, by_class = {}, {}
        for op in mine:
            ms, n = by_name.get(op["name"], (0.0, 0))
            by_name[op["name"]] = (ms + op["dur_ms"], n + 1)
            cls = _kernel_class(op["name"])
            by_class[cls] = by_class.get(cls, 0.0) + op["dur_ms"]
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
        out[scope or "unscoped"] = {
            "device_ms": sum(op["dur_ms"] for op in mine), "ops": len(mine),
            "by_class_ms": by_class,
            "top": [{"op": name.replace("void at::native::", "")[:160], "ms": ms, "count": n}
                    for name, (ms, n) in ranked]}
    return out


def _traced_counts(ops: list) -> dict:
    """Each wrapper's kernels in the trace's ProfilerStep windows, and those
    that lie under another scope than their phase's."""
    counts = {k: 0 for k in TRACED_KERNELS}
    misplaced = []
    for op in ops:
        if op["step"] is None:
            continue
        for kernel, (part, scope) in TRACED_KERNELS.items():
            if part in op["name"]:
                counts[kernel] += 1
                if op["scope"] != scope:
                    misplaced.append((kernel, op["scope"], op["name"][:60]))
    return {"counts": counts, "misplaced": misplaced}


def _profile_in_process() -> dict:
    """(a): bench.py:561-565's train step in the split form on a one-rank
    NCCL mesh, a StepRecorder boundary a step, a capture of 2 steps; its
    trace held against the launch counters over the same window."""
    import torch.distributed as dist

    config = TransformerConfig(**TRAIN_CONFIG)
    mesh = MeshSpec({"dp": 1}).build()
    collective_mod.init_collective_group(1, 0, backend="nccl", group_name="profile")
    try:
        setup = setup_sharded_training(
            lambda device: init_params(config, seed=SEED, device=device), make_optimizer,
            mesh=mesh, logical_dims=param_logical_dims(config))
        # The dispatch takes the split form above one worker only, as the
        # reference's does; a capture traces its scopes at one.
        step = torch_utils._split_step(
            lambda params, tok: loss_fn(params, tok[:, :-1], tok[:, 1:], config), setup,
            "profile", lambda x: x.to_local())
        rng = np.random.default_rng(SEED + 3)
        tokens = torch.from_numpy(
            rng.integers(0, config.vocab_size, (TRAIN_BATCH, config.max_seq + 1))).cuda()
        batch = setup.shard_batch(tokens)
        step_stats_mod.activate()
        recorder = step_stats_mod.StepRecorder(_ProfileCtx())
        plane = profiler_mod.get_plane()
        # Boundary i ends step i, as a session's i-th report does.
        armed = plane.arm({"capture_id": "phase22", "start_step": PROFILE_START,
                           "steps": PROFILE_CAPTURE, "max_s": 120.0,
                           "session_dir": str(PROFILE_DIR)})
        require(armed["status"] == "ok", f"profiler: arm {armed}")
        params, opt = setup.params, setup.opt_state
        walls, boundaries, records, window = [], [], [], {}
        for i in range(PROFILE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, batch)
            loss = float(loss)
            t1 = time.perf_counter()
            # The boundary starts the trace (CUPTI's start-up) and stops and
            # exports it: its own time, outside the step's.
            records.append(recorder.on_report({"tokens": TRAIN_BATCH * config.max_seq}))
            boundaries.append(time.perf_counter() - t1)
            walls.append(t1 - t0)
            recorder.mark_resume()
            if i + 1 == PROFILE_START:
                window["before"] = _counts()
            if i + 1 == PROFILE_START + PROFILE_CAPTURE:
                window["after"] = _counts()
        require(np.isfinite(loss), f"profiler: loss {loss}")
        cap = plane.collect()
        stats = dict(step.stats)
        del params, opt, setup, step, batch
    finally:
        step_stats_mod.deactivate()
        collective_mod.destroy_collective_group("profile")
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    require(cap["status"] == "ok" and cap["device_error"] is None,
            f"profiler: capture {cap.get('status')}, device error {cap.get('device_error')}")
    require([b["step"] for b in cap["boundaries"]] ==
            list(range(PROFILE_START - 1, PROFILE_START + PROFILE_CAPTURE)),
            f"profiler: boundaries {cap['boundaries']}")
    trace_path = os.path.join(cap["device_trace_dir"], profiler_mod.TRACE_FILE)
    trace_bytes = os.path.getsize(trace_path)
    start = time.perf_counter()
    events = _trace_events(cap["device_trace_dir"])
    attributed = _attribute(events)
    parse_s = time.perf_counter() - start
    want = {k: window["after"][k] - window["before"][k] for k in TRACED_KERNELS}
    traced = _traced_counts(attributed["ops"])
    ops = attributed["ops"]
    adamw = [op for op in ops if ADAMW_KERNEL in op["name"] and op["step"] is not None]
    breakdown = _scope_breakdown(ops)
    # The capture's cost: its second step (the first pays CUPTI's start-up)
    # against the uncaptured steps after the warm-up one.
    uncaptured = [walls[i] for i in range(1, PROFILE_STEPS)
                  if not PROFILE_START <= i < PROFILE_START + PROFILE_CAPTURE]
    result = dict(
        config="bench.py:561-565", mesh={"dp": 1}, steps=PROFILE_STEPS,
        captured_steps=list(range(PROFILE_START, PROFILE_START + PROFILE_CAPTURE)),
        step_ms=[1e3 * w for w in walls],
        captured_second_step_ms=1e3 * walls[PROFILE_START + 1],
        uncaptured_step_ms=1e3 * statistics.mean(uncaptured),
        capture_overhead_ms=1e3 * (walls[PROFILE_START + 1] - statistics.mean(uncaptured)),
        first_captured_step_ms=1e3 * walls[PROFILE_START], split_stats=stats,
        boundary_ms=[1e3 * b for b in boundaries],
        trace_bytes=trace_bytes, trace_events=len(events), trace_parse_s=parse_s,
        profiler_steps=attributed["steps"], attribution=attributed["methods"],
        launches_in_window=want, traced=traced["counts"], misplaced=traced["misplaced"][:10],
        adamw_kernels=len(adamw), adamw_outside_opt=sum(op["scope"] != "opt" for op in adamw),
        breakdown=breakdown, phase_totals=cap["phase_totals"],
        step_stats=records[PROFILE_START + 1],
        kernel_forwards=PROFILE_STEPS, kernel_backwards=PROFILE_STEPS, plain_forwards=0)
    log("profiler_in_process", **result)
    require(attributed["steps"] == [f"ProfilerStep#{k}" for k in range(PROFILE_CAPTURE)],
            f"profiler: ProfilerStep ranges {attributed['steps']}")
    require(attributed["scopes"] == list(PROFILE_SCOPES) * PROFILE_CAPTURE,
            f"profiler: scopes {attributed['scopes']}")
    require(traced["counts"] == want,
            f"profiler: kernels in the trace {traced['counts']} != launches {want}")
    require(all(want.values()), f"profiler: a kernel with no launch in the window {want}")
    require(not traced["misplaced"], f"profiler: kernels under another scope "
                                     f"{traced['misplaced'][:5]}")
    require(adamw and not result["adamw_outside_opt"],
            f"profiler: AdamW's {len(adamw)} kernels, {result['adamw_outside_opt']} outside opt")
    require(not any(_kernel_class(o["name"]) in ("flash", "rmsnorm", "gemm", "adamw")
                    for o in ops if o["scope"] == "grad_sync"),
            f"profiler: grad_sync holds compute {breakdown['grad_sync']}")
    return result


def _profiled_trainer_run() -> tuple:
    """(b): trainer_loop on one GPU worker, 6 steps, no failure and no save,
    the split step; capture_profile(steps=2) from a driver thread, taken at
    the round of the first report."""
    trainer = TorchTrainer(
        trainer_loop, train_loop_config={"die_after": None, "save": False, "split": True,
                                         "probe": True},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True, mesh_axes={"dp": 1}),
        run_config=RunConfig(name="profiled", storage_path=str(PROFILE_DIR)))
    answer = {}
    thread = threading.Thread(target=lambda: answer.update(
        record=trainer.capture_profile(steps=2, timeout_s=600.0)))
    thread.start()
    try:
        result = trainer.fit()
    finally:
        thread.join(660)
    require(not thread.is_alive(), "profiler: capture_profile did not return")
    return result, answer["record"]


def _profile_trainer() -> dict:
    """(b), checked: the record's status, the merged trace's step and phase
    slices on rank 0, the worker's trace holding B1-B4, each report's
    device_kind, the worker's HBM probe against its card."""
    gc.collect()
    torch.cuda.empty_cache()
    start = time.perf_counter()
    # Traced: the worker's step marks carry its execute span's ids into the
    # merged trace's trace_ids, each of which must be a span the session holds.
    # The cluster starts inside, so that its member inherits the tracing
    # environment; every process of it exports under the cluster's session.
    with traced("profiler") as own:
        with on_runtime("profiler", num_cpus=8) as session:
            result, record = _profiled_trainer_run()
            trace_ids = record.get("trace_ids") or []
            spans = _spans_when(session, lambda found: set(trace_ids) <= {
                s["trace_id"] for s in found})
    wall = time.perf_counter() - start
    shutil.rmtree(own, ignore_errors=True)
    span_traces = {s["trace_id"] for s in spans}
    OBSERVABILITY["profiler"] = {"trace_ids": trace_ids, "spans": _span_counts(spans),
                                 "ids_in_spans": all(t in span_traces for t in trace_ids)}
    require(result.error is None, f"profiler trainer: {result.error}")
    require(record.get("status") == "ok", f"profiler trainer: capture {record}")
    require(trace_ids and all(t in span_traces for t in trace_ids),
            f"profiler trainer: trace_ids {trace_ids}, the session's spans' traces "
            f"{sorted(span_traces)}")
    with open(record["path"]) as f:
        merged = json.load(f)
    slices = [e for e in merged["traceEvents"] if e.get("ph") == "X" and e["pid"] == 0]
    step_slices = [e for e in slices if e.get("cat") == "step"]
    phase_slices = [e for e in slices if e.get("cat") == "phase"]
    inside = all(any(s["ts"] <= p["ts"] and p["ts"] + p["dur"] <= s["ts"] + s["dur"]
                     for s in step_slices) for p in phase_slices)
    device_dir = merged["metadata"]["device_trace_dirs"]["0"]
    worker_ops = _attribute(_trace_events(device_dir))["ops"]
    worker_counts = _traced_counts(worker_ops)["counts"]
    kind = torch.cuda.get_device_name(0)
    kinds = {r.get("device_kind") for r in result.step_stats[0]}
    probes = [(m["hbm"], m["allocated"], m["total_memory"]) for m in result.metrics_history]
    counts = result.metrics_history[-1]["counts"]
    require_member_leases("profiler trainer", result.attempts)
    out = dict(
        config="bench.py:133-138", steps=len(result.metrics_history), record=record,
        merged_step_slices=[e["args"]["step"] for e in step_slices],
        merged_phase_slices=[e["name"] for e in phase_slices], phases_inside_steps=inside,
        worker_trace_counts=worker_counts, device_kinds=sorted(k or "" for k in kinds),
        hbm=probes[-1][0], allocated=probes[-1][1], total_memory=probes[-1][2],
        step_stats_keys=sorted(result.step_stats[0][-1]), wall_s=wall,
        step_ms=[1e3 * m["step_s"] for m in result.metrics_history], counts=counts,
        routes=result.metrics_history[-1]["routes"])
    log("profiler_trainer", **out)
    require(len(step_slices) == 2 and len(phase_slices) == 2 * len(PROFILE_SCOPES) and inside,
            f"profiler trainer: {len(step_slices)} step slices, phases {out['merged_phase_slices']}")
    require(all(worker_counts[k] > 0 for k in TRACED_KERNELS),
            f"profiler trainer: the worker's trace holds {worker_counts}")
    require(kinds == {kind}, f"profiler trainer: device_kind {kinds}, the card is {kind}")
    require(all(h and allocated <= h["hbm_used"] <= total and h["hbm_total"] <= total
                for h, allocated, total in probes),
            f"profiler trainer: hbm_stats {probes}")
    return out


def _profile_hier() -> dict:
    """(c): a one-rank hier group and a one-rank SliceTopology mesh on the
    card, the two-tier sums held bitwise against their input."""
    import torch.distributed as dist

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = _randn(gen, (1024, 4096), torch.float32)
    collective_mod.init_collective_group(1, 0, backend="hier", group_name="hier")
    try:
        group = collective_mod.get_group("hier")
        sharded = group.allreduce_sharded([x])
        topology = SliceTopology({"tp": 1}, {"dp": 1})
        mesh = topology.build_mesh()
        tiers = topology.hierarchical_psum(x, mesh)
        via_grad_psum = torch_utils.grad_psum(x, topology=topology, mesh=mesh)
        checks = dict(backend=group.backend_name, tier2=dist.get_backend(),
                      sharded_bitwise=bool(torch.equal(sharded, x)),
                      tiers_bitwise=bool(torch.equal(tiers, x)),
                      grad_psum_bitwise=bool(torch.equal(via_grad_psum, x)),
                      mesh=list(mesh.mesh_dim_names))
    finally:
        collective_mod.destroy_collective_group("hier")
    checks["destroyed"] = not dist.is_initialized()
    log("profiler_hier", **checks)
    require(all(v for k, v in checks.items() if k.endswith("bitwise") or k == "destroyed"),
            f"profiler hier: {checks}")
    return checks


def phase_profiler() -> dict:
    """Phase 22: (a) the in-process capture of phase 7's cell, (b) a
    TorchTrainer capture, (c) a one-rank hier group. Returns the numbers,
    the passes (a) ran through the kernels in this process, and (b)'s
    worker counts and routes."""
    if PROFILE_DIR.exists():
        shutil.rmtree(PROFILE_DIR)
    try:
        start = time.perf_counter()
        in_process = _profile_in_process()
        trainer = _profile_trainer()
        hier = _profile_hier()
    finally:
        shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    return {**{k: in_process[k] for k in ("kernel_forwards", "kernel_backwards",
                                          "plain_forwards")},
            "in_process": in_process, "trainer": trainer, "hier": hier,
            "seconds": time.perf_counter() - start}


# ---------------------------------------------------------------- phase 23
# BASELINE config 4 as release/serve_bert_http.py:30-140 sets it, its
# non-tiny branch uncut: BERT-base widths in bf16 behind the HTTP proxy.
BERT_CONFIG = dict(vocab_size=30522, dim=768, n_layers=12, n_heads=12, n_kv_heads=12,
                   hidden_dim=3072, max_seq=128, dtype=torch.bfloat16)
BERT_SEQ = 32
HTTP_CLIENTS = 16
HTTP_SECONDS = 8.0
HTTP_PAYLOAD = {"token_ids": [101, 2023, 2003, 1037, 3231, 102]}
# Extra bursts until the autoscaler's second replica runs, at most this long.
HTTP_SCALE_WAIT_S = 90.0
SSE_TOKENS = 32
# The replica's device window: a burst of this many seconds, profiled for
# the middle DEVICE_WINDOW_S of it.
DEVICE_BURST_S = 3.0
DEVICE_WINDOW_S = 1.0
# Seeded requests with other first tokens, each held against a direct forward.
HTTP_CHECKS = 8


def _bert_tokens(bodies: list, seq: int) -> np.ndarray:
    """release/serve_bert_http.py's layout: ids left-aligned in zeros."""
    tokens = np.zeros((len(bodies), seq), dtype=np.int64)
    for i, body in enumerate(bodies):
        ids = (body or {}).get("token_ids") or [101, 102]
        tokens[i, : min(len(ids), seq)] = ids[:seq]
    return tokens


@serve.deployment(
    max_ongoing_requests=64,
    autoscaling_config=serve.AutoscalingConfig(
        min_replicas=1, max_replicas=2, target_ongoing_requests=8, upscale_delay_s=1.0),
    ray_actor_options={"num_gpus": 0.5},
)
class BertEncoder:
    """release/serve_bert_http.py's BertEncoder on the port: random weights
    from the seed, every batch bucket warmed at init, logits[:, 0, :8] as
    float64 lists."""

    def __init__(self, config_kwargs: dict, seed: int, device: str):
        # Where a replica's start goes: wall-clock marks for the driver,
        # which knows when it asked for the replica.
        self.init_marks = {"init_started": time.time()}
        self.forward_s = 0.0
        self.config = TransformerConfig(**config_kwargs)
        self.device = device
        self.params = init_params(self.config, seed=seed, device=device)
        self.seq = min(BERT_SEQ, self.config.max_seq)
        self.init_marks["params"] = time.time()
        for bucket in BUCKETS:
            self._forward(np.zeros((bucket, self.seq), np.int64))
        if device == "cuda":
            torch.cuda.synchronize()
        self.init_marks["warm"] = time.time()

    def _forward(self, tokens: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            return forward(self.params, torch.from_numpy(tokens).to(self.device), self.config)

    def placement(self, _) -> dict:
        """Read inside the replica: the cards its runtime lease lets it see,
        the device it opened, and where its weights are."""
        return {"pid": os.getpid(), "lease": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "current_device": (torch.cuda.current_device() if self.device == "cuda"
                                   else None),
                "params_device": str(self.params["embed"].device)}

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.005, bucket_sizes=BUCKETS)
    async def __call__(self, bodies):
        start = time.perf_counter()
        logits = self._forward(_bert_tokens(bodies, self.seq))
        out = logits[:, 0, :8].double().cpu().numpy()
        # The batch's wall time on the serving loop, its answer copied back.
        self.forward_s += time.perf_counter() - start
        return [{"embedding": row.tolist()} for row in out]

    async def device_window(self, seconds: float) -> dict:
        """This replica's device time over a window of its serving loop,
        from torch.profiler's records of what ran on the card. The profiler
        starts, stops and parses on a thread of its own (CUDA activity is
        the process's), so the loop serves on meanwhile."""

        def window() -> dict:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                batches = serve_batching.queue_stats()["batches"]
                forward_s = self.forward_s
                start = time.perf_counter()
                time.sleep(seconds)
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - start) * 1e3
                batches = serve_batching.queue_stats()["batches"] - batches
                forward_s = self.forward_s - forward_s
            rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                           for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                           and not getattr(e, "is_user_annotation", False)),
                          key=lambda r: -r[1])
            device_ms = sum(r[1] for r in rows)
            return {"window_ms": window_ms, "device_ms": device_ms, "batches": batches,
                    "forward_ms_mean": 1e3 * forward_s / max(1, batches),
                    "device_ms_per_batch": device_ms / max(1, batches),
                    "device_ops": sum(r[2] for r in rows),
                    "idle_share": 1.0 - device_ms / window_ms,
                    "top": [{"op": k[:60], "ms": ms, "count": n} for k, ms, n in rows[:5]]}

        result = await asyncio.get_running_loop().run_in_executor(None, window)
        return {**result, "pid": os.getpid(), "init_marks": self.init_marks}


@serve.deployment
class TokenStreamer:
    """release/serve_bert_http.py's token-streaming deployment (a CPU
    replica)."""

    def __call__(self, body):
        n = int((body or {}).get("n", 8))
        for i in range(n):
            yield {"token": f"t{i}"}


def http_load(conn, port: int, path: str, clients: int) -> None:
    """The load generator, a process of its own so that its threads do not
    take the proxy's interpreter: `clients` threads, each on one keep-alive
    http.client connection, post the payload back to back for each burst
    the parent asks for (("go", seconds, payload)), and report each
    request's start, latency and status, and the distinct answers."""
    import http.client

    conn.send("ready")
    while True:
        command = conn.recv()
        if command[0] != "go":
            break
        _, seconds, payload = command
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        t0 = time.perf_counter()
        deadline = t0 + seconds
        results: list = []
        answers: dict = {}
        lock = threading.Lock()

        def client():
            mine, seen = [], {}
            http_conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            while time.perf_counter() < deadline:
                start = time.perf_counter()
                try:
                    http_conn.request("POST", path, body=body, headers=headers)
                    resp = http_conn.getresponse()
                    data = resp.read()
                    status = resp.status
                except (OSError, http.client.HTTPException) as exc:
                    status, data = f"{type(exc).__name__}: {exc}", b""
                    http_conn.close()
                    http_conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                mine.append((start - t0, time.perf_counter() - start, status))
                if status == 200:
                    seen[data] = seen.get(data, 0) + 1
            http_conn.close()
            with lock:
                results.extend(mine)
                for data, n in seen.items():
                    answers[data] = answers.get(data, 0) + n

        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        conn.send({"results": results, "answers": [(json.loads(d)["embedding"], n)
                                                    for d, n in answers.items()],
                   "seconds": time.perf_counter() - t0})


def _percentile_ms(latencies: list, q: float) -> float:
    ordered = sorted(latencies)
    return 1e3 * ordered[min(len(ordered) - 1, int(len(ordered) * q))]


def _proc_cpu_s(pid: int) -> float:
    """CPU seconds (user and system) of process ``pid``, from /proc (Linux)."""
    fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


# ---------------------------------------------------------------- serve on the runtime
# Phases 23, 27 and 30 run the serve plane on ray_tpu_torch.init(), as their
# release scripts do: the controller, the proxies and the replicas are actors
# of the runtime, each replica's card share leased from the node agent. Each
# phase boots its cluster and shuts it down at its end, so that no phase
# inherits another's actors.
def _ctl(controller, method: str, *args, timeout: float = 60.0):
    """The serve controller actor's ``method``, waited for."""
    return rt.get(getattr(controller, method).remote(*args), timeout=timeout)


def _serve_metrics(controller, qname: str, at_rest: bool = False) -> list:
    """The deployment's running replicas' metrics, each with its launch
    counts asked of its actor (``Replica.kernel_launches``). ``at_rest``:
    each replica's batches and launches from one read of it
    (``Replica.get_metrics``), read again every 0.1 s, up to
    METRICS_AT_REST_S, until two reads agree. A hedge's losing copy can
    still be in a replica's forward after its request was answered, its
    batch counted and not all its launches made."""
    if not at_rest:
        metrics = _ctl(controller, "get_metrics").get(qname, [])
        for m in metrics:
            actor = rt.get_actor(f"SERVE_REPLICA::{m['replica_id']}")
            m["kernels"] = rt.get(actor.kernel_launches.remote(), timeout=60)
        return metrics

    def read() -> dict:
        return {m["pid"]: m for m in _ctl(controller, "get_metrics").get(qname, [])}

    def moving(metrics: dict) -> dict:
        return {pid: (m["batches"], m["kernels"]) for pid, m in metrics.items()}

    deadline = time.monotonic() + METRICS_AT_REST_S
    last = read()
    while True:
        time.sleep(0.1)
        now = read()
        if moving(now) == moving(last) or time.monotonic() > deadline:
            return list(now.values())
        last = now


# How long _serve_metrics(at_rest=True) waits for the counts to stop moving.
METRICS_AT_REST_S = 5.0


def _serve_down() -> None:
    serve.shutdown()
    rt.shutdown()


def _start_split(asked_at: float, marks: dict) -> dict:
    """A replica's start: when its constructor began, counted from the
    phase's first serve.run (for the first replica, the spawn and the
    imports), and the seconds its weights and its warm-up forwards took."""
    return {"init_started_after_run_s": marks["init_started"] - asked_at,
            "params_s": marks["params"] - marks["init_started"],
            "warm_s": marks["warm"] - marks["params"]}


def _burst_summary(burst: dict) -> dict:
    """A burst's length, requests, percentiles and slowest request."""
    latencies = [lat for _, lat, _ in burst["results"]]
    slowest = max(burst["results"], key=lambda r: r[1])
    return {"seconds": burst["seconds"], "requests": len(latencies),
            "p50_ms": _percentile_ms(latencies, 0.5), "p99_ms": _percentile_ms(latencies, 0.99),
            "max_ms": 1e3 * slowest[1], "slowest_started_at_s": slowest[0]}


def _replica_counts(metrics: list) -> tuple:
    """The replicas' launch counts summed, in _counts()'s and
    _route_counts()'s forms, and the forwards they ran: each replica's
    flushed batches and its len(BUCKETS) warm-up forwards."""
    names = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
             "rmsnorm", "rmsnorm_bwd")
    counts = {k: sum(m["kernels"][k]["launches"] for m in metrics) for k in names}
    routes = {k: {r: sum(m["kernels"][k]["launches_by_route"][r] for m in metrics)
                  for r in ("wgmma", "mma_sync")} for k in names[:3]}
    forwards = sum(m["batches"] + len(BUCKETS) for m in metrics)
    return counts, routes, forwards


def phase_serve_http(config_kwargs=None, device="cuda", seconds=HTTP_SECONDS) -> dict:
    """Phase 23: BASELINE config 4 through the port's serve plane. The
    encoder deployment (num_gpus 0.5, autoscaled 1 to 2 replicas) behind
    the HTTP proxy; HTTP_CLIENTS clients post for `seconds`, then more
    bursts until the second replica runs; a profiled burst; 32 tokens of
    TokenStreamer as SSE; answers against a direct forward in this process.
    The kernels launch in the replicas, whose counts come back in their
    metrics."""
    import torch.multiprocessing as mp

    config_kwargs = config_kwargs or BERT_CONFIG
    config = TransformerConfig(**config_kwargs)
    port = _bert_port()
    start, asked_at = time.perf_counter(), time.time()
    rt.init(num_cpus=8)
    controller = serve.start(http_port=port)
    proxy_pid = _ctl(controller, "get_proxies")[0]["pid"]
    encoder = BertEncoder if device == "cuda" else BertEncoder.options(ray_actor_options={})
    # The load generator's process starts beside the replicas, one wave of
    # process starts instead of two; it sends nothing before its first "go".
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    loader = ctx.Process(target=http_load, args=(child, port, "/bert", HTTP_CLIENTS))
    loader.start()
    try:
        # The streamer's CPU replica starts beside the encoder's.
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            streamer = pool.submit(serve.run, TokenStreamer.bind(), name="stream",
                                   route_prefix="/stream")
            handle = serve.run(encoder.bind(config_kwargs, SEED, device), name="bert",
                               route_prefix="/bert")
            first_replica_s = time.perf_counter() - start
            streamer.result(120)

        def running() -> int:
            return serve.status()["bert"]["deployments"]["BertEncoder"]["running_replicas"]

        try:
            require(parent.poll(120) and parent.recv() == "ready", "serve_http: load generator")

            def burst(length: float, during=None) -> dict:
                parent.send(("go", length, HTTP_PAYLOAD))
                extra = during() if during else None
                require(parent.poll(length + 120), "serve_http: the load generator went silent")
                out = parent.recv()
                out["during"] = extra
                return out

            replicas_seen, reached_s = [], None
            go = time.perf_counter()

            def watch():
                nonlocal reached_s
                while not parent.poll(0.05):
                    n = running()
                    replicas_seen.append((time.perf_counter() - go, n))
                    if n >= 2 and reached_s is None:
                        reached_s = time.perf_counter() - go

            proxy_cpu = _proc_cpu_s(proxy_pid)
            main = burst(seconds, watch)
            proxy_cpu = _proc_cpu_s(proxy_pid) - proxy_cpu
            bursts = [main]
            while reached_s is None and time.perf_counter() - go < HTTP_SCALE_WAIT_S:
                bursts.append(burst(4.0, watch))
            # A profiled window of one replica, in a burst of its own.
            window = None
            if device == "cuda":
                # One replica, by the hash ring's key: a first, empty window
                # while no load runs takes the profiler's start-up (seconds
                # in which the replica's loop stalls), then the measured one.
                profiled_replica = handle.options(session_id="device-window").device_window
                profiled_replica.remote(0.0).result(timeout=120)

                def profile_one():
                    time.sleep((DEVICE_BURST_S - DEVICE_WINDOW_S) / 2)
                    return profiled_replica.remote(DEVICE_WINDOW_S).result(timeout=120)
                profiled = burst(DEVICE_BURST_S, profile_one)
                window = profiled["during"]
                bursts.append(profiled)
            parent.send(("stop",))
        finally:
            loader.join(30)
            if loader.is_alive():
                loader.kill()
        status_after = serve.status()["bert"]["deployments"]["BertEncoder"]
        placements = list(_by_replica(handle, "placement",
                                      status_after["running_replicas"]).values())

        # Seeded requests with other tokens, over HTTP, for the check below.
        rng = np.random.default_rng(SEED + 23)
        check_bodies = [{"token_ids": rng.integers(0, config.vocab_size, BERT_SEQ).tolist()}
                        for _ in range(HTTP_CHECKS)]
        check_answers = [_post_json(port, "/bert", body) for body in check_bodies]

        sse_start = time.perf_counter()
        sse = _post_json(port, "/stream", {"n": SSE_TOKENS}, {"Accept": "text/event-stream"},
                         raw=True)
        sse_s = time.perf_counter() - sse_start
        sse_tokens = sum(1 for line in sse.decode().splitlines() if line.startswith("data: "))
        metrics = _serve_metrics(controller, "bert_BertEncoder", at_rest=True)
    finally:
        if loader.is_alive():
            loader.kill()
        _serve_down()
    shutdown_s = time.perf_counter() - start

    # The direct forward of the same tokens, in this process.
    params = init_params(config, seed=SEED, device=device)
    bodies = [HTTP_PAYLOAD] + check_bodies
    with torch.inference_mode():
        direct_logits = forward(params, torch.from_numpy(
            _bert_tokens(bodies, min(BERT_SEQ, config.max_seq))).to(device), config)
    direct = direct_logits[:, 0, :8].double().cpu().numpy()
    del params, direct_logits

    latencies = [lat for _, lat, status in main["results"]]
    failed = [status for b in bursts for _, _, status in b["results"] if status != 200]
    answer_errs = [float(np.abs(np.asarray(emb) - direct[0]).max())
                   for b in bursts for emb, _ in b["answers"]]
    answer_errs += [float(np.abs(np.asarray(a["embedding"]) - direct[i + 1]).max())
                    for i, a in enumerate(check_answers)]
    counts, routes, forwards = _replica_counts(metrics)
    real = sum(m["items_real"] for m in metrics)
    padded = sum(m["items_padded"] for m in metrics)
    result = dict(
        config="release/serve_bert_http.py non-tiny (BERT-base widths, bf16)",
        params=num_params(init_params(config, seed=SEED, device="meta")),
        clients=HTTP_CLIENTS, seconds=seconds, requests=len(latencies),
        qps=len(latencies) / main["seconds"], p50_ms=_percentile_ms(latencies, 0.50),
        p95_ms=_percentile_ms(latencies, 0.95), p99_ms=_percentile_ms(latencies, 0.99),
        max_ms=1e3 * max(latencies), failed=len(failed), failed_samples=failed[:5],
        requests_all_bursts=sum(len(b["results"]) for b in bursts),
        bursts=[_burst_summary(b) for b in bursts],
        replicas_reached=max(n for _, n in replicas_seen), replicas_reached_s=reached_s,
        replicas_after=status_after, first_replica_s=first_replica_s,
        mean_batch_occupancy=real / padded if padded else None,
        mean_batch_size=real / sum(m["batches"] for m in metrics),
        batches=sum(m["batches"] for m in metrics), forwards=forwards,
        replica_totals=[m["total"] for m in metrics],
        # The HTTP proxy actor's process (its serve I/O loop, its handles
        # and their actor calls) over the main burst: its CPU seconds a
        # request and its share of the burst's wall time.
        proxy_cpu_us_per_request=1e6 * proxy_cpu / max(1, len(latencies)),
        proxy_busy_share=proxy_cpu / main["seconds"],
        sse_tokens=sse_tokens, sse_tokens_per_s=sse_tokens / sse_s, sse_seconds=sse_s,
        device_window=window, max_answer_err=max(answer_errs), answer_tol=LOGITS_TOL,
        replica_start_s=window and _start_split(asked_at, window["init_marks"]),
        placements=placements,
        distinct_answers=sum(len(b["answers"]) for b in bursts),
        counts=counts, routes=routes, phase_seconds=shutdown_s)
    log("serve_http", **result)
    require(not failed, f"serve_http: {len(failed)} requests failed: {failed[:5]}")
    require(all(np.isfinite(direct).ravel()), "serve_http: non-finite direct logits")
    require(max(answer_errs) < LOGITS_TOL,
            f"serve_http: answers {max(answer_errs)} from the direct forward >= {LOGITS_TOL}")
    require(result["replicas_reached"] == 2, f"serve_http: replicas {replicas_seen[-5:]}")
    require(sse_tokens == SSE_TOKENS, f"serve_http: {sse_tokens} SSE tokens")
    if device == "cuda":
        # Each replica's weights on the one card its half-card lease names.
        require(all(p["lease"] == "0" and p["current_device"] == 0
                    and p["params_device"] == "cuda:0" for p in placements),
                f"serve_http: replica placements {placements}")
    return result


def _bert_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _post_json(port: int, path: str, body, headers=None, raw: bool = False):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        require(resp.status == 200, f"serve_http: {path} answered {resp.status}: {data[:200]}")
        return data if raw else json.loads(data)
    finally:
        conn.close()


# ---------------------------------------------------------------- phase 24
# Tune (ray_tpu_torch/tune/): BASELINE config 3 as release/tune_asha_resnet.py
# defines it, then TorchTrainer trials at ResNet-18's full width. Every
# trial is a runtime actor; it finds its trainable by module and name (user
# code goes by name, never by value), here this script imported as
# ``chip_smoke``, so the trainables are module-level functions. A trainer
# trial's gang member is an actor the trial's actor starts.
# The ResNets' convolutions are cuDNN's (phase 19): no kernel of the port
# runs, in this process or in a trial's (each report carries its counts).
ASHA_EPOCHS, ASHA_STEPS, ASHA_IMAGES = 8, 4, 32
ASHA_SPACE = {"lr": [1e-2, 1e-3, 1e-4], "width": [8, 16]}
ASHA_RUNGS = (2, 4, 8)
# The trial whose first report is held against the same trainable run
# here on the CPU, within tests/test_torch_cnn.py's bound on an f32 loss
# (F32_TOL, over max(1, |loss|)); its accuracy must be equal.
ASHA_CHECKED = {"lr": 1e-3, "width": 8}
ASHA_LOSS_TOL = 2e-5
TUNE_LRS = [1e-2, 1e-3, 1e-4]
TUNE_REPORTS, TUNE_STEPS = 8, 4
TUNE_STORAGE = Path(__file__).resolve().parent / "build" / "chip_smoke_tune"
# A stopped trial's gang members must be gone within this of the stop.
GANG_GONE_S = 10.0
# (a)'s trials each lease this share of the card (the 8 CPUs' default
# concurrency at one CPU a trial); (b)'s three trainer trials a third each.
ASHA_GPU_SHARE = 0.125
TUNE_GPU_SHARE = 1 / 3


def asha_resnet_run(config: dict, params: dict, device, report, epochs: int = ASHA_EPOCHS):
    """release/tune_asha_resnet.py:20-54 from `params`: the ResNet at
    config["width"] with one block a stage, Adam(config["lr"]) at optax's
    defaults, the script's 32 seeded images with labels `sum > 0`, and
    report({"acc", "loss"}) after each epoch of ASHA_STEPS steps (the
    loss and accuracy of its last step, before that step's update)."""
    from ray_tpu_torch.models.cnn import ResNetConfig, resnet_loss

    rc = ResNetConfig(width=config["width"], blocks_per_stage=(1, 1))
    rng = np.random.default_rng(0)
    images = rng.normal(size=(ASHA_IMAGES, 32, 32, 3)).astype(np.float32)
    labels = (images.sum(axis=(1, 2, 3)) > 0).astype(np.int32)
    images = torch.from_numpy(images).to(device)
    labels = torch.from_numpy(labels).to(device)
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(params)]
    optimizer = torch.optim.Adam(leaves, lr=config["lr"], betas=(0.9, 0.999), eps=1e-8)
    for _ in range(epochs):
        for _ in range(ASHA_STEPS):
            loss, acc = resnet_loss(params, images, labels, rc)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        report({"acc": float(acc), "loss": float(loss.detach())})


def asha_resnet_trainable(config: dict) -> None:
    """BASELINE config 3's trainable on the card: the release script's
    non-smoke branch (8 epochs of 4 steps), f32 with TF32 off, weights from
    init_resnet(seed=0) on cuda. Each report also carries the wall times
    at which the function began (its process spawned, imports done) and
    its weights were on the card (the CUDA context made)."""
    from ray_tpu_torch.models.cnn import ResNetConfig, init_resnet

    began = time.time()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    params = init_resnet(ResNetConfig(width=config["width"], blocks_per_stage=(1, 1)),
                         seed=0, device="cuda")
    torch.cuda.synchronize()
    marks = {"began": began, "cuda_ready": time.time()}
    asha_resnet_run(config, params, "cuda", lambda metrics: tune.report(
        {**metrics, **marks, "launches": sum(_counts().values())}))


def tune_trainer_loop(config: dict) -> None:
    """Phase 24 (b)'s train_loop_per_worker, in a gang member on the card:
    ResNetConfig() (ResNet-18, width 64) at batch RESNET_BATCH on seeded
    32 x 32 x 3 images, f32 with TF32 off, TUNE_REPORTS reports of
    TUNE_STEPS Adam steps, each step ending in a synchronize. Reports the
    steps' seconds, peak memory, this process's id and the wall times at
    which its loop began (its gang ready) and its model and data were on
    the card."""
    from ray_tpu_torch.models.cnn import ResNetConfig, init_resnet, resnet_loss
    from ray_tpu_torch.train import get_context, report

    ready = time.time()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device(get_context().device)
    torch.cuda.reset_peak_memory_stats(device)
    rc = ResNetConfig()
    params = init_resnet(rc, SEED, device)
    rng = np.random.default_rng(SEED + 24)
    images = torch.from_numpy(rng.standard_normal((RESNET_BATCH, 32, 32, 3))
                              .astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, rc.num_classes, RESNET_BATCH)).to(device)
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(params)]
    optimizer = torch.optim.Adam(leaves, lr=config["lr"], betas=(0.9, 0.999), eps=1e-8)
    torch.cuda.synchronize(device)
    model_ready = time.time()
    for _ in range(TUNE_REPORTS):
        step_s = []
        for _ in range(TUNE_STEPS):
            torch.cuda.synchronize(device)
            start = time.perf_counter()
            loss, _ = resnet_loss(params, images, labels, rc)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - start)
        report({"loss": float(loss.detach()), "step_s": step_s, "pid": os.getpid(),
                "gang_ready": ready, "model_ready": model_ready,
                "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
                "device_name": torch.cuda.get_device_name(device),
                "lease": [os.environ.get("CUDA_VISIBLE_DEVICES"),
                          torch.cuda.current_device()],
                "launches": sum(_counts().values())})


class _TrialClock:
    """A Tune callback: each trial's start (its addition, just before its
    process is spawned), its results' arrival times and the gang members'
    process ids its results name."""

    def __init__(self):
        self.added, self.results, self.pids = {}, {}, {}

    def on_trial_add(self, trial) -> None:
        self.added[trial.trial_id] = time.time()

    def on_trial_result(self, trial, result: dict) -> None:
        self.results.setdefault(trial.trial_id, []).append(time.time())
        if "pid" in result:
            self.pids[trial.trial_id] = result["pid"]


class RecordingASHA(ASHAScheduler):
    """An ASHAScheduler that records every call the controller makes of it
    (what it was fed, what it answered, when), for the replay check."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.calls = []

    def _fed(self, result: dict) -> dict:
        return {k: result[k] for k in (self.time_attr, self.metric) if k in result}

    def on_trial_add(self, controller, trial) -> None:
        self.calls.append(("add", trial.trial_id, None, None, time.time()))
        super().on_trial_add(controller, trial)

    def on_trial_result(self, controller, trial, result: dict) -> str:
        decision = super().on_trial_result(controller, trial, result)
        self.calls.append(("result", trial.trial_id, self._fed(result), decision, time.time()))
        return decision

    def on_trial_complete(self, controller, trial, result: dict) -> None:
        self.calls.append(("complete", trial.trial_id, self._fed(result), None, time.time()))
        super().on_trial_complete(controller, trial, result)


def _replay_asha(calls: list, **kwargs) -> list:
    """The decisions a fresh ASHAScheduler gives for the recorded calls."""
    fresh, trials, decisions = ASHAScheduler(**kwargs), {}, []
    for kind, trial_id, fed, _, _ in calls:
        trial = trials.setdefault(trial_id, types.SimpleNamespace(trial_id=trial_id))
        if kind == "add":
            fresh.on_trial_add(None, trial)
        elif kind == "result":
            decisions.append(fresh.on_trial_result(None, trial, fed))
        else:
            fresh.on_trial_complete(None, trial, fed)
    return decisions


def _stop_times(calls: list) -> dict:
    return {trial_id: at for kind, trial_id, _, decision, at in calls if decision == "STOP"}


def _alive(pid: int) -> bool:
    """Whether `pid` runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


class _GoneWatch:
    """Polls the gang members the clock has seen, every 20 ms, and notes
    when each stops running."""

    def __init__(self, clock: _TrialClock):
        self.clock, self.gone = clock, {}
        # The trials whose member only close()'s last poll found gone.
        self.seen_at_close: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="gone-watch", daemon=True)
        self._thread.start()

    def _poll(self) -> list:
        found = [trial_id for trial_id, pid in list(self.clock.pids.items())
                 if trial_id not in self.gone and not _alive(pid)]
        for trial_id in found:
            self.gone[trial_id] = time.time()
        return found

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            self._poll()

    def close(self) -> dict:
        self._stop.set()
        self._thread.join()
        # A member that ended after the thread's last poll: the caller may
        # have seen it end first (the last trial's member ends as fit()
        # does), and the thread stops without looking again.
        self.seen_at_close = self._poll()
        return self.gone


def _tune_config3() -> dict:
    """(a): release/tune_asha_resnet.py's sweep (lines 60-80) at the port's
    default concurrency."""
    from ray_tpu_torch.models.cnn import ResNetConfig, init_resnet

    asha = dict(metric="acc", mode="max", grace_period=2, max_t=8, reduction_factor=2)
    scheduler, clock = RecordingASHA(**asha), _TrialClock()
    start = time.perf_counter()
    results = tune.Tuner(
        # Each trial's actor leases a share of the card, or it sees none.
        tune.with_resources(asha_resnet_trainable, {"CPU": 1, "GPU": ASHA_GPU_SHARE}),
        param_space={k: tune.grid_search(v) for k, v in ASHA_SPACE.items()},
        tune_config=tune.TuneConfig(metric="acc", mode="max", scheduler=scheduler),
        run_config=RunConfig(name="tune_asha_resnet", storage_path=str(TUNE_STORAGE),
                             callbacks=[clock]),
    ).fit()
    wall = time.perf_counter() - start
    require(len(results) == 6 and results.num_errors == 0
            and all(r.metrics_history for r in results),
            f"tune config 3: {len(results)} trials, errors {results.errors}")
    best = results.get_best_result()
    early_stopped = sum(1 for r in results if r.metrics.get("training_iteration", 8) < 8)
    script = {"benchmark": "tune_asha_resnet", "num_trials": len(results),
              "early_stopped": early_stopped, "best_acc": best.metrics["acc"],
              "best_config": best.config}
    trials = []
    for r in results:
        iters = [m["training_iteration"] for m in r.metrics_history]
        added, first = clock.added[r.trial_id], r.metrics_history[0]
        arrived = clock.results[r.trial_id][0]
        trials.append({"config": r.config, "last_iteration": r.metrics["training_iteration"],
                       "acc": r.metrics["acc"], "loss": r.metrics["loss"],
                       # The time to the first result, then split: the spawn
                       # and imports until the function began, the CUDA
                       # context and weights, the first epoch.
                       "first_result_s": arrived - added,
                       "spawn_imports_s": first["began"] - added,
                       "cuda_s": first["cuda_ready"] - first["began"],
                       "first_epoch_s": arrived - first["cuda_ready"],
                       "last_result_s": clock.results[r.trial_id][-1] - added,
                       "iterations": iters,
                       "launches": [m["launches"] for m in r.metrics_history]})
    # The checked trial's first epoch again, here on the CPU, from the same
    # weights (init_resnet's CUDA generator, copied).
    config = dict(ASHA_CHECKED)
    weights = _tree_to(init_resnet(ResNetConfig(width=config["width"], blocks_per_stage=(1, 1)),
                                   seed=0, device="cuda"), "cpu")
    cpu = []
    asha_resnet_run(config, weights, "cpu", cpu.append, epochs=1)
    (checked,) = [r for r in results if r.config == config]
    first = checked.metrics_history[0]
    loss_err = abs(first["loss"] - cpu[0]["loss"]) / max(1.0, abs(cpu[0]["loss"]))
    replayed = _replay_asha(scheduler.calls, **asha)
    recorded = [decision for kind, _, _, decision, _ in scheduler.calls if kind == "result"]
    out = dict(script, wall_s=wall, trials=trials, concurrency=os.cpu_count(),
               checked={"config": config, "card": {k: first[k] for k in ("acc", "loss")},
                        "cpu": cpu[0], "loss_err": loss_err, "tol": ASHA_LOSS_TOL},
               decisions=recorded, replay_equal=replayed == recorded)
    for t in trials:
        require(t["last_iteration"] in ASHA_RUNGS and t["iterations"] == list(
            range(1, t["last_iteration"] + 1)), f"tune config 3: trial ended off a rung: {t}")
        require(not any(t["launches"]), f"tune config 3: kernel launches in a trial: {t}")
    require(replayed == recorded, "tune config 3: the controller's decisions differ from a "
            f"fresh ASHAScheduler's on the recorded stream: {recorded} vs {replayed}")
    require(best.metrics["acc"] == max(r.metrics["acc"] for r in results),
            "tune config 3: best_acc is not the highest last acc")
    require(all(np.isfinite([t["loss"] for t in trials])), "tune config 3: non-finite loss")
    require(loss_err < ASHA_LOSS_TOL and first["acc"] == cpu[0]["acc"],
            f"tune config 3: first report on the card {first} vs the CPU's {cpu[0]}")
    return out


def _tune_trainers() -> dict:
    """(b): Tuner(TorchTrainer) over three learning rates, one GPU worker a
    trial, three trials at once, under ASHA on the loss."""
    asha = dict(metric="loss", mode="min", grace_period=2, max_t=8, reduction_factor=2)
    scheduler, clock = RecordingASHA(**asha), _TrialClock()
    watch = _GoneWatch(clock)
    # A third of the card each: the three trials hold it at once.
    trainer = TorchTrainer(tune_trainer_loop,
                           scaling_config=ScalingConfig(
                               num_workers=1, use_gpu=True,
                               resources_per_worker={"GPU": TUNE_GPU_SHARE}),
                           run_config=RunConfig(name="resnet18",
                                                storage_path=str(TUNE_STORAGE / "trainer")))
    start = time.perf_counter()
    try:
        results = tune.Tuner(
            trainer, param_space={"train_loop_config": {"lr": tune.grid_search(TUNE_LRS)}},
            tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=scheduler,
                                        max_concurrent_trials=3),
            run_config=RunConfig(name="tune_trainers", storage_path=str(TUNE_STORAGE),
                                 callbacks=[clock]),
        ).fit()
    finally:
        wall = time.perf_counter() - start
        # The trials' actors and their gangs' members, which the node agent
        # started: all gone within GANG_GONE_S of fit()'s end (a kill is
        # asynchronous, and a member of a trial killed hard follows it).
        pids = sorted({a["pid"] for a in runtime_actors(("_TrialActor",)) if a.get("pid")}
                      | set(clock.pids.values()))
        deadline = time.monotonic() + GANG_GONE_S
        while any(_alive(p) for p in pids) and time.monotonic() < deadline:
            time.sleep(0.02)
        gone = watch.close()
    left = [p for p in pids if _alive(p)]
    stops = _stop_times(scheduler.calls)
    require(len(results) == 3 and results.num_errors == 0
            and all(len(r.metrics_history) >= 2 for r in results),
            f"tune trainers: {len(results)} trials, errors {results.errors}")
    trials = []
    for r in results:
        history, tid = r.metrics_history, r.trial_id
        first, added, arrived = history[0], clock.added[tid], clock.results[tid][0]
        steps = [s for m in history[1:] for s in m["step_s"]]  # the first round warms cuDNN
        trials.append({
            "lr": r.config["train_loop_config"]["lr"],
            "iterations": [m["training_iteration"] for m in history],
            "img_per_s": RESNET_BATCH / statistics.median(steps),
            "step_ms": 1e3 * statistics.median(steps),
            "peak_gib": max(m["peak_gib"] for m in history),
            "gang_ready_s": first["gang_ready"] - added,
            "first_report_s": arrived - added,
            # The time to the first report, split: the trial's spawn and
            # imports until its trainable began (the first result's arrival
            # less its time_total_s), the gang's formation, the member's
            # CUDA context, model and data, and the first round's steps.
            "trial_spawn_imports_s": arrived - first["time_total_s"] - added,
            "gang_formation_s": first["gang_ready"] - (arrived - first["time_total_s"]),
            "member_cuda_s": first["model_ready"] - first["gang_ready"],
            "first_round_s": arrived - first["model_ready"],
            # Below 0 where the loop had ended, and its gang with it, before
            # the controller read the last result and decided.
            "stop_to_gone_s": gone[tid] - stops[tid] if tid in gone and tid in stops else None,
            "through_trainer": all("factorization" in m for m in history),
            "launches": [m["launches"] for m in history],
            "device_name": first["device_name"], "lease": first["lease"],
            "gang_ready": first["gang_ready"], "last_result": clock.results[tid][-1]})
    early_stopped = sum(1 for t in trials if t["iterations"][-1] < 8)
    # At once: every trial's gang was on the card before any trial's last
    # result.
    at_once = max(t["gang_ready"] for t in trials) < min(t["last_result"] for t in trials)
    out = dict(wall_s=wall, early_stopped=early_stopped, trials=trials, gpu_share=TUNE_GPU_SHARE,
               at_once=at_once, processes_checked=len(pids), processes_left=left,
               gone_seen_at_close=watch.seen_at_close)
    for t in trials:
        require(t["iterations"] == list(range(1, len(t["iterations"]) + 1))
                and t["through_trainer"],
                f"tune trainers: reports did not come through the trainer's callbacks: {t}")
        require(t["stop_to_gone_s"] is not None and t["stop_to_gone_s"] < GANG_GONE_S,
                f"tune trainers: a stopped trial's gang member outlived {GANG_GONE_S} s: {t}; "
                f"processes alive after fit(): {left}")
        require(not any(t["launches"]), f"tune trainers: kernel launches in a worker: {t}")
    require(not left, f"tune trainers: processes alive {GANG_GONE_S} s after fit(): {left}")
    require(at_once, f"tune trainers: the three trials did not hold the card at once: {trials}")
    require(all(t["lease"] == ["0", 0] for t in trials),
            f"tune trainers: the members' leases {[t['lease'] for t in trials]}")
    return out


def phase_tune(resnet_img_per_s: float) -> dict:
    shutil.rmtree(TUNE_STORAGE, ignore_errors=True)
    start = time.perf_counter()
    try:
        # release/tune_asha_resnet.py:63's init.
        with on_runtime("tune", num_cpus=8):
            result = {"config3": _tune_config3(), "trainers": _tune_trainers()}
    finally:
        shutil.rmtree(TUNE_STORAGE, ignore_errors=True)
    result["phase19_resnet_img_per_s"] = resnet_img_per_s
    result["seconds"] = time.perf_counter() - start
    # The release script's own JSON, then the phase's line.
    log("tune_asha_resnet", **{k: result["config3"][k] for k in
                               ("benchmark", "num_trials", "early_stopped", "best_acc",
                                "best_config")})
    log("tune", **result)
    return result


# ---------------------------------------------------------------- phase 25
# Elasticity in the port's trainer, on the runtime's node agent, and
# BASELINE config 1 through the trainer. Its checkpoints go to
# ELASTIC_STORAGE, removed at the phase's end.
ELASTIC_STORAGE = Path(__file__).resolve().parent / "build" / "chip_smoke_elastic"
# (a) release/train_fashion_mnist.py:66-83 (not its smoke scale).
FMNIST_WORKERS, FMNIST_BATCH, FMNIST_LR, FMNIST_STEPS = 2, 64, 1e-3, 30
# (b) phase 14's loop at one layer: a checkpoint at step 1, the worker's
# hard exit after step 1's report, steps to 4.
ELASTIC_LAYERS, ELASTIC_STEPS, ELASTIC_SAVE_AT, ELASTIC_DIE_AFTER = 1, 4, 1, 1
ELASTIC_FORMATION_TIMEOUT_S = 2.0
# (c) release/benchmarks_elastic.py at RAY_TPU_RELEASE_SMOKE=1, with its
# trainer settings.
CHURN_STEPS, CHURN_STEP_S, CHURN_KILL = 10, 0.05, 3


def fmnist_loop(config):
    """(a)'s worker: the release script's loop on the port, then the check
    that the worker loaded nothing of JAX or the JAX package."""
    release_loops.fashion_mnist_loop(config)
    require_no_reference("config 1 worker")


def churn_loop(config):
    """(c)'s worker: release/benchmarks_elastic.py's loop on the port, then
    the same check."""
    release_loops.quadratic_loop(config)
    require_no_reference("churn worker")


def _fmnist_run(name: str, workers: int, use_gpu: bool, params: dict):
    result = TorchTrainer(
        fmnist_loop,
        train_loop_config={"lr": FMNIST_LR, "batch_size": FMNIST_BATCH, "steps": FMNIST_STEPS,
                           "params": params, "logits": True},
        scaling_config=ScalingConfig(num_workers=workers, use_gpu=use_gpu),
        run_config=RunConfig(name=name, storage_path=str(ELASTIC_STORAGE))).fit()
    require(result.error is None, f"config 1 {name}: {result.error}")
    return result


def _elastic_config1() -> dict:
    """(a): config 1 as the release script runs it, on two CPU workers,
    then on one GPU worker from the same params and batch; the first
    step's logits on the card against the CPU worker's."""
    from ray_tpu_torch.models.cnn import CNNConfig, init_cnn
    from ray_tpu_torch.models.convert import conv_params_to_numpy

    params = conv_params_to_numpy(init_cnn(CNNConfig(), SEED, "cpu"))
    cpu = _fmnist_run("fmnist_cpu", FMNIST_WORKERS, False, params)
    card = _fmnist_run("fmnist_card", 1, True, params)
    cpu_logits = np.asarray(cpu.metrics["first_logits"])
    card_logits = np.asarray(card.metrics["first_logits"])
    err = float(np.abs(card_logits - cpu_logits).max()
                / max(1.0, float(np.abs(cpu_logits).max())))
    out = dict(
        config="release/train_fashion_mnist.py:66-83: ScalingConfig(num_workers=2), CNNConfig(), "
               "batch 64, Adam 1e-3, 30 steps after one warm-up",
        img_per_s=cpu.metrics["img_per_s"], final_loss=cpu.metrics["loss"],
        final_acc=cpu.metrics["acc"], card_img_per_s=card.metrics["img_per_s"],
        card_final_loss=card.metrics["loss"], card_final_acc=card.metrics["acc"],
        logits_err=err, logits_tol=CNN_LOGITS_TOL,
        worker_launches=[cpu.metrics["launches"], card.metrics["launches"]],
        gang_form_s=[cpu.attempts[0]["formed"] - cpu.attempts[0]["start"],
                     card.attempts[0]["formed"] - card.attempts[0]["start"]],
        goodput=[cpu.goodput, card.goodput])
    # The release script's own JSON line.
    log("train_fashion_mnist", benchmark="train_fashion_mnist", img_per_s=out["img_per_s"],
        final_loss=out["final_loss"])
    require(err < CNN_LOGITS_TOL, f"config 1: first logits on the card vs the CPU worker {err}")
    require(all(np.isfinite([out["final_loss"], out["card_final_loss"]])),
            f"config 1: losses {out['final_loss']}, {out['card_final_loss']}")
    require(out["worker_launches"] == [0, 0],
            f"config 1: kernel launches in the workers {out['worker_launches']}")
    out["card_leases"] = require_member_leases("config 1", card.attempts)
    return out


def _elastic_tokens() -> "rd.Dataset":
    """(b)'s dataset: ELASTIC_STEPS x SHARDED_BATCH rows of seeded tokens
    at the sharded config's sequence (release_loops.token_rows), one block
    a step's batch, made by the local pool."""
    local_tasks.init(num_workers=DATA_WORKERS)
    return rd.range(ELASTIC_STEPS * SHARDED_BATCH, parallelism=ELASTIC_STEPS).map_batches(
        release_loops.token_rows, fn_kwargs={
            "seed": SEED, "vocab_size": SHARDED_CONFIG["vocab_size"],
            "length": SHARDED_CONFIG["max_seq"] + 1}).materialize()


def _elastic_card_run(name: str, elastic: bool, die_after: int | None, tokens):
    sc = ScalingConfig(num_workers=2 if elastic else 1, min_workers=1 if elastic else None,
                       use_gpu=True, mesh_axes=SHARDED_MESH,
                       elastic_formation_timeout_s=ELASTIC_FORMATION_TIMEOUT_S)
    result = TorchTrainer(
        trainer_loop,
        train_loop_config={"die_after": die_after, "n_layers": ELASTIC_LAYERS,
                           "steps": ELASTIC_STEPS, "save_at": ELASTIC_SAVE_AT, "dataset": True,
                           "death_file": str(ELASTIC_STORAGE / f"{name}.death")},
        scaling_config=sc,
        run_config=RunConfig(name=name, storage_path=str(ELASTIC_STORAGE),
                             failure_config=FailureConfig(max_failures=1),
                             checkpoint_config=CheckpointConfig(num_to_keep=1)),
        datasets={"train": tokens}).fit()
    # The committed ingest record, read before the run's directory goes.
    ingest = StorageContext(str(ELASTIC_STORAGE), name).latest_ingest()
    shutil.rmtree(result.path, ignore_errors=True)
    require(result.error is None, f"elastic {name}: {result.error}")
    death = ELASTIC_STORAGE / f"{name}.death"
    result.died_at = float(death.read_text()) if death.exists() else None
    return result, ingest


def _elastic_step_down() -> dict:
    """(b): ScalingConfig(num_workers=2, min_workers=1) on the one card,
    its tokens read from a Dataset shard (``TorchTrainer(datasets=)``).
    Formation at 2 does not place (the node agent has one card; the
    controller parks the group until the formation's timeout), the gang
    forms at 1; its
    worker exits hard after step 1's report, and the gang re-forms at 1
    from the step-1 checkpoint and its ingest record. The resumed steps
    must equal a fixed world-1 run's bitwise, and the rows each run
    consumed must be the dataset's, over the death and the resume, with
    at most 3 batches a rank of the first gang read twice (the bound of
    tests/test_train_elastic.py:180-183). Returns the numbers and the
    workers' launch counts, summed over their processes."""
    gc.collect()
    torch.cuda.empty_cache()  # the workers share the card with this process
    tokens = _elastic_tokens()
    (stepped, ingest), (whole, _) = (_elastic_card_run("elastic_card", True, ELASTIC_DIE_AFTER,
                                                       tokens),
                                     _elastic_card_run("fixed_card", False, None, tokens))

    def steps(result):
        return [m["step"] for m in result.metrics_history]

    formations = [[(f["world_size"], f["formed"]) for f in a["formations"]]
                  for a in stepped.attempts]
    require(formations == [[(2, False), (1, True)]] * 2,
            f"elastic: formations {[a['formations'] for a in stepped.attempts]}")
    require([a["ended_by"] for a in stepped.attempts] == ["gang_died", "done"]
            and [(r["reason"], r["from"], r["to"]) for r in stepped.resizes]
            == [("gang_died", 1, None)], f"elastic: {stepped.attempts} {stepped.resizes}")
    want = list(range(1, ELASTIC_DIE_AFTER + 1)) + list(range(ELASTIC_SAVE_AT + 1,
                                                              ELASTIC_STEPS + 1))
    require(steps(stepped) == want and steps(whole) == list(range(1, ELASTIC_STEPS + 1)),
            f"elastic: steps {steps(stepped)}, {steps(whole)}")
    require(all(m["world"] == 1 for m in stepped.metrics_history),
            "elastic: a worker saw a world other than 1")
    resumed = stepped.metrics_history[ELASTIC_DIE_AFTER:]
    uninterrupted = whole.metrics_history[ELASTIC_SAVE_AT:]
    bitwise = ([m["loss"] for m in resumed] == [m["loss"] for m in uninterrupted]
               and resumed[-1]["digest"] == uninterrupted[-1]["digest"])
    last_of = {}
    for m in stepped.metrics_history + whole.metrics_history:
        last_of[m["pid"]] = m
    lasts = list(last_of.values())
    require(len(lasts) == 3, f"elastic: reports came from {len(lasts)} worker processes")
    counts = {k: sum(m["counts"][k] for m in lasts) for k in lasts[0]["counts"]}
    routes = {k: {r: sum(m["routes"][k][r] for m in lasts) for r in ("wgmma", "mma_sync")}
              for k in lasts[0]["routes"]}
    ran = len(steps(stepped)) + len(steps(whole))
    first, second = stepped.attempts
    rows = ELASTIC_STEPS * SHARDED_BATCH
    stepped_ids = [i for m in stepped.metrics_history for i in m["ids"]]
    whole_ids = [i for m in whole.metrics_history for i in m["ids"]]
    replayed = len(stepped_ids) - rows
    replay_bound = 3 * SHARDED_BATCH * first["world_size"]
    out = dict(
        config=f"phase 14's loop at {ELASTIC_LAYERS} layer (bench.py:133-138 widths)",
        scaling="ScalingConfig(num_workers=2, min_workers=1, use_gpu=True, "
                f"elastic_formation_timeout_s={ELASTIC_FORMATION_TIMEOUT_S})",
        bitwise=bitwise, losses=[m["loss"] for m in whole.metrics_history],
        resumed_losses=[m["loss"] for m in resumed],
        step_down_wait_s=[a["formations"][0]["seconds"] for a in stepped.attempts],
        formation_s=[a["formations"][1]["seconds"] for a in stepped.attempts],
        fixed_formation_s=whole.attempts[0]["formations"][0]["seconds"],
        formations=[a["formations"] for a in stepped.attempts],
        first_report_s=[a["first_report"] - a["formed"] for a in stepped.attempts],
        timeline=_timeline(stepped),
        restore_s=resumed[0]["restore_s"], save_s=stepped.metrics_history[0].get("save_s"),
        ckpt_bytes=stepped.metrics_history[0].get("ckpt_bytes"),
        restart_s=second["first_report"] - first["end"],
        death_to_report_s=second["first_report"] - stepped.died_at,
        goodput=stepped.goodput, fixed_goodput=whole.goodput, counts=counts, routes=routes,
        kernel_forwards=ran, kernel_backwards=ran, dataset_rows=rows,
        ids_by_step=[m["ids"] for m in stepped.metrics_history], replayed_rows=replayed,
        replay_bound=replay_bound, ingest=ingest)
    require(bitwise, f"elastic: resumed steps {resumed} differ from the fixed run's "
                     f"{uninterrupted}")
    # The group of two cards was parked until the formation's timeout, not
    # refused at once.
    require(all(w >= 0.9 * ELASTIC_FORMATION_TIMEOUT_S for w in out["step_down_wait_s"]),
            f"elastic: the step-down waits {out['step_down_wait_s']} against "
            f"{ELASTIC_FORMATION_TIMEOUT_S} s")
    out["leases"] = require_member_leases("elastic", stepped.attempts + whole.attempts)
    require(sorted(set(stepped_ids)) == list(range(rows)) and 0 <= replayed <= replay_bound,
            f"elastic: the stepped run consumed {stepped_ids} of {rows} rows "
            f"(at most {replay_bound} read twice)")
    require(sorted(whole_ids) == list(range(rows)),
            f"elastic: the fixed run consumed {whole_ids} of {rows} rows")
    require(ingest is not None and ingest["world_size"] == 1
            and ingest["datasets"]["train"][0]["rows"] == ELASTIC_SAVE_AT * SHARDED_BATCH,
            f"elastic: the committed ingest record {ingest}")
    require(stepped.goodput["restart_s"] > 0 and stepped.goodput["stalled_s"] > 0,
            f"elastic: goodput {stepped.goodput}")
    require(all(counts[k] > 0 for k in counts), f"elastic: worker launch counts {counts}")
    return out


def _timeline(result) -> list:
    """Each gang of a run, in seconds from the run's start: its attempt's
    start, formation and end, its formation attempts, and where the one
    that formed spent its time: the spawn to the last member's entry (the
    processes' start and imports), to the last member's joined groups,
    and to the formed gang."""
    t0 = result.attempts[0]["start"]
    out = []
    for a in result.attempts:
        entered = max(m["entered"] for m in a["members"])
        joined = max(m["joined"] for m in a["members"])
        out.append({"start": a["start"] - t0, "formed": a["formed"] - t0,
                    "first_report": a.get("first_report", a["end"]) - t0, "end": a["end"] - t0,
                    "world_size": a["world_size"], "ended_by": a["ended_by"],
                    "formations": [(f["world_size"], f["formed"], f["seconds"])
                                   for f in a["formations"]],
                    "spawn_to_entered_s": entered - a["spawned"],
                    "entered_to_joined_s": joined - entered,
                    "joined_to_formed_s": a["formed"] - joined})
    return out


def _elastic_churn() -> dict:
    """(c): release/benchmarks_elastic.py's two fits on CPU gloo workers,
    4 of them with min_workers 2, each leasing a CPU and one of the 4
    trainslots its cluster declares. The churned fit's callback kills rank
    3 at step CHURN_KILL and holds its slot from an actor until the gang
    reports a world of 3. Prints the script's keys and where the churned
    fit's wall went."""
    pid_dir = ELASTIC_STORAGE / "pids"
    pid_dir.mkdir(parents=True, exist_ok=True)

    def fit(name: str, callbacks: list):
        start = time.monotonic()
        result = TorchTrainer(
            churn_loop,
            train_loop_config={"steps": CHURN_STEPS, "step_time_s": CHURN_STEP_S,
                               "pid_dir": str(pid_dir)},
            scaling_config=ScalingConfig(
                num_workers=4, min_workers=2, use_gpu=False,
                resources_per_worker={"CPU": 1, "trainslot": 1},
                elastic_formation_timeout_s=1.0, elastic_grow_probe_period_s=0.05),
            run_config=RunConfig(name=name, storage_path=str(ELASTIC_STORAGE),
                                 failure_config=FailureConfig(max_failures=4),
                                 callbacks=callbacks)).fit()
        return result, time.monotonic() - start

    base, base_wall = fit("elastic-base", [])
    churn = release_loops.Churn(str(pid_dir), kill_step=CHURN_KILL)
    try:
        churned, churn_wall = fit("elastic-churn", [churn])
    finally:
        churn.release()
    # The last gang's placement group is given back asynchronously: the
    # node agent's free slots within SETTLE_S.
    deadline = time.monotonic() + SETTLE_S
    while rt.available_resources()["trainslot"] < 4 and time.monotonic() < deadline:
        time.sleep(0.05)
    left = rt.available_resources()["trainslot"]
    require(base.error is None and churned.error is None,
            f"churn: {base.error} {churned.error}")
    base_loss, churn_loss = (release_loops.loss_by_step(base),
                             release_loops.loss_by_step(churned))
    covered = sorted(set(base_loss) & set(churn_loss))
    loss_max_dev = (max(abs(base_loss[s] - churn_loss[s]) for s in covered)
                    if len(covered) == CHURN_STEPS else float("inf"))
    reasons = [r["reason"] for r in churned.resizes]
    out = dict(
        steps=CHURN_STEPS, wall_undisturbed_s=base_wall, wall_churn_s=churn_wall,
        wall_ratio=churn_wall / base_wall, loss_max_dev=loss_max_dev,
        resizes=len(churned.resizes), grew_back=int("grow" in reasons),
        finished=int(churned.error is None and churned.metrics.get("step") == CHURN_STEPS - 1),
        final_world_size=churned.metrics.get("world_size", 0))
    log("benchmarks_elastic", **out)
    reports = [m["step"] for m in churned.metrics_history]
    out.update(resize_reasons=reasons, churn_reports=reports,
               replayed_steps=len(reports) - CHURN_STEPS, base_timeline=_timeline(base),
               churn_timeline=_timeline(churned), goodput=churned.goodput,
               base_goodput=base.goodput, trainslots_left=left)
    require(loss_max_dev == 0 and out["grew_back"] == 1 and out["finished"] == 1
            and out["final_world_size"] == 4, f"churn: {out}")
    require(reasons == ["gang_died", "grow"] and left == 4, f"churn: resizes {reasons}, "
                                                             f"{left} trainslots free after")
    return out


def phase_elastic() -> dict:
    shutil.rmtree(ELASTIC_STORAGE, ignore_errors=True)
    ELASTIC_STORAGE.mkdir(parents=True)
    start = time.perf_counter()
    try:
        # release/train_fashion_mnist.py:72's init for (a) and (b); the churn
        # declares its trainslots in its own.
        with on_runtime("elastic", num_cpus=8):
            result = {"config1": _elastic_config1(), "step_down": _elastic_step_down()}
        with on_runtime("elastic_churn", num_cpus=8, resources={"trainslot": 4}):
            result["churn"] = _elastic_churn()
    except BaseException:
        local_tasks.shutdown()
        raise
    finally:
        shutil.rmtree(ELASTIC_STORAGE, ignore_errors=True)
    # The pool that made (b)'s Dataset stays up for phase 26, which shuts it
    # down: one wave of process starts instead of two.
    result["seconds"] = time.perf_counter() - start
    log("elastic", **result)
    return result


# ---------------------------------------------------------------- phase 26
# ray_tpu_torch.data on this host's pool, and BASELINE config 1 fed by it.
# The trainer's checkpoints go to DATA_STORAGE, removed at the phase's end.
DATA_STORAGE = Path(__file__).resolve().parent / "build" / "chip_smoke_data"
# Pool processes (the host has 8 cores; the trainer's worker needs one),
# and range's blocks: 7,500 rows each.
DATA_WORKERS, DATA_BLOCKS, DATA_BATCH = 4, 8, 64
DATA_REPORT_EVERY = 100


def data_worker_devices(batch):
    """A map_batches UDF: the CUDA devices the data worker that runs it
    sees, and its pid."""
    return {"pid": np.full(len(batch["id"]), os.getpid()),
            "devices": np.full(len(batch["id"]), torch.cuda.device_count()),
            "visible": np.array([os.environ.get("CUDA_VISIBLE_DEVICES", "unset")]
                                * len(batch["id"]))}


def fmnist_dataset_loop(config):
    """(b)'s worker: config 1's loop fed by the trainer's dataset, then the
    check that the worker loaded nothing of JAX or the JAX package."""
    release_loops.fashion_mnist_dataset_loop(config)
    require_no_reference("config 1 dataset worker")


def _data_plane(rows: int = release_loops.FMNIST_TRAIN_ROWS) -> tuple:
    """(a): range(rows) -> map_batches(fashion_mnist_rows) -> random_shuffle
    (seed 0) -> one epoch of iter_batches(batch_size=64), each stage timed
    (the map and the shuffle materialized in turn). The epoch's ids must be
    a permutation of range(rows), other than the identity, and every row's
    image and label equal to fashion_mnist_rows computed here. Returns the
    numbers and the shuffled Dataset."""
    runtime = local_tasks.init(num_workers=DATA_WORKERS)
    pool_start_s = runtime.pool_ready_s()
    seen = rd.range(4 * DATA_WORKERS, parallelism=4 * DATA_WORKERS).map_batches(
        data_worker_devices).take_all()
    require(all(r["devices"] == 0 and r["visible"] == "" for r in seen),
            f"data: a data worker sees a CUDA device: {seen}")
    t0 = time.perf_counter()
    mapped = rd.range(rows, parallelism=DATA_BLOCKS).map_batches(
        release_loops.fashion_mnist_rows, fn_kwargs={"seed": SEED}).materialize()
    t1 = time.perf_counter()
    shuffled = rd.from_block_refs(mapped._refs()).random_shuffle(seed=0).materialize()
    # The shuffle's merge tasks run behind the refs it hands back.
    local_tasks.wait(shuffled._refs(), num_returns=shuffled.num_blocks())
    t2 = time.perf_counter()
    batches = list(shuffled.iter_batches(batch_size=DATA_BATCH))
    t3 = time.perf_counter()
    store = local_tasks.store_stats()
    want = release_loops.fashion_mnist_rows({"id": np.arange(rows)}, seed=SEED)
    expected_s = time.perf_counter() - t3
    ids = np.concatenate([b["id"] for b in batches])
    images = np.concatenate([b["image"] for b in batches])
    labels = np.concatenate([b["label"] for b in batches])
    out = dict(
        rows=rows, blocks=DATA_BLOCKS, workers=DATA_WORKERS, batch=DATA_BATCH,
        worker_cuda_devices=sorted({r["devices"] for r in seen}),
        workers_seen=len({r["pid"] for r in seen}),
        batches=len(batches), pool_start_s=pool_start_s, map_s=t1 - t0, shuffle_s=t2 - t1,
        epoch_s=t3 - t2, rows_per_s=rows / (t3 - t0), epoch_rows_per_s=rows / (t3 - t2),
        store_used_bytes=store["used"], store_capacity_bytes=store["capacity"],
        store_dir=runtime.store.dir, expected_s=expected_s,
        # Summed in id order, as the expected rows are.
        image_checksum=float(images[np.argsort(ids)].astype(np.float64).sum()),
        expected_checksum=float(want["image"].astype(np.float64).sum()),
        identity_order=bool(np.array_equal(ids, np.arange(rows))))
    require(np.array_equal(np.sort(ids), np.arange(rows)),
            f"data: the epoch's ids are not a permutation of range({rows})")
    require(not out["identity_order"], "data: random_shuffle left the rows in order")
    require(np.array_equal(images, want["image"][ids]) and np.array_equal(labels,
                                                                         want["label"][ids]),
            "data: the epoch's images or labels differ from fashion_mnist_rows of their ids")
    require(out["image_checksum"] == out["expected_checksum"],
            f"data: image checksum {out['image_checksum']} vs {out['expected_checksum']}")
    return out, shuffled


def _data_config1(shuffled, fixed_img_per_s: float, use_gpu: bool = True) -> dict:
    """(b): release/train_fashion_mnist.py's loop (batch 64, Adam 1e-3) on
    one card worker through TorchTrainer(datasets=), reading one epoch of
    (a)'s shuffled rows through get_dataset_shard("train").
    iter_torch_batches(batch_size=64, drop_last=True): 937 steps. img/s
    beside phase 25's fixed-batch figure, and the ingest share of a step
    from the StepStats records' data wait."""
    from ray_tpu_torch.models.cnn import CNNConfig, init_cnn
    from ray_tpu_torch.models.convert import conv_params_to_numpy

    rows = shuffled.count()
    params = conv_params_to_numpy(init_cnn(CNNConfig(), SEED, "cpu"))
    result = TorchTrainer(
        fmnist_dataset_loop,
        train_loop_config={"lr": FMNIST_LR, "batch_size": DATA_BATCH, "params": params,
                           "report_every": DATA_REPORT_EVERY},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=use_gpu),
        run_config=RunConfig(name="fmnist_dataset", storage_path=str(DATA_STORAGE)),
        datasets={"train": shuffled}).fit()
    require(result.error is None, f"data config 1: {result.error}")
    m = result.metrics
    records = result.step_stats.get(0, [])
    # The first record holds the model's set-up and the warm-up step.
    timed = records[1:]
    wall = sum(r["wall_s"] for r in timed)
    wait = sum(r["data_wait_s"] for r in timed)
    steps = rows // DATA_BATCH
    out = dict(
        config="release/train_fashion_mnist.py:66-83's loop (CNNConfig(), batch 64, Adam 1e-3) "
               "on one card worker, one epoch of the Dataset",
        steps=m["steps"], rows=m["rows"], img_per_s=m["img_per_s"],
        fixed_batch_img_per_s=fixed_img_per_s, final_loss=m["loss"], final_acc=m["acc"],
        timed_s=m["timed_s"], loop_data_wait_s=m["data_wait_s"],
        loop_ingest_share=m["data_wait_s"] / m["timed_s"],
        step_stats_records=len(records), step_stats_wall_s=wall, step_stats_data_wait_s=wait,
        ingest_share=wait / wall if wall else None, worker_launches=m["launches"],
        gang_form_s=result.attempts[0]["formed"] - result.attempts[0]["start"],
        goodput=result.goodput)
    require(m["steps"] == steps and m["rows"] == steps * DATA_BATCH
            and m["distinct_rows"] == m["rows"], f"data config 1: {m}")
    require(np.isfinite(m["loss"]), f"data config 1: loss {m['loss']}")
    require(m["launches"] == 0, f"data config 1: kernel launches in the worker {m['launches']}")
    require(len(records) >= steps // DATA_REPORT_EVERY, f"data config 1: {len(records)} records")
    if use_gpu:
        out["leases"] = require_member_leases("data config 1", result.attempts)
    return out


def phase_data(fixed_img_per_s: float) -> dict:
    """Phase 26: (a) the data plane alone, (b) config 1 fed by it; the pool
    is stopped and its store removed at the end."""
    shutil.rmtree(DATA_STORAGE, ignore_errors=True)
    DATA_STORAGE.mkdir(parents=True)
    start = time.perf_counter()
    try:
        plane, shuffled = _data_plane()
        log("data_plane", **plane)
        # release/train_fashion_mnist.py:72's init for (b)'s trainer.
        with on_runtime("data", num_cpus=8):
            config1 = _data_config1(shuffled, fixed_img_per_s)
        del shuffled
        store_dir = local_tasks.runtime().store.dir
        pool = list(local_tasks.runtime().pool)
    finally:
        local_tasks.shutdown()
        shutil.rmtree(DATA_STORAGE, ignore_errors=True)
    require(not os.path.exists(store_dir) and not any(e.proc.is_alive() for e in pool),
            "data: the pool or its store outlived shutdown()")
    result = {"plane": plane, "config1": config1, "seconds": time.perf_counter() - start}
    log("data", **result)
    return result


# ---------------------------------------------------------------- phase 27
# The serve plane's multiplexing and reliability on the card: (a) phase
# 23's encoder as a multiplexed deployment, (b) the chaos bench's phases 1
# and 2 (release/benchmarks_serve_chaos.py) deployed from YAML.
MUX_MODELS = ("m0", "m1", "m2", "m3")
MUX_SHARES = (0.4, 0.3, 0.2, 0.1)
MUX_CLIENTS, MUX_SECONDS, MUX_PER_REPLICA = 16, 6.0, 2
# Seeded requests a model id, after the traffic, each held against a
# direct forward of that model's weights.
MUX_CHECKS = 2
CHAOS_CLIENTS, CHAOS_SECONDS = 8, 4.0
# When the chaos window's kills land, from its start (the bench's times).
CHAOS_REPLICA_KILL_S, CHAOS_PROXY_KILL_S = 1.0, 2.5
CHAOS_RECOVER_S = 90.0
# How many of each window's slowest requests the record lists.
CHAOS_SLOWEST = 16
# The chaos deployment's device: its YAML cannot carry init arguments.
CHAOS_DEVICE = "cuda"
SERVE_SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke_serve"


def _mux_seed(model_id: str) -> int:
    """A model's weights come from a seed its id gives (m<k>: SEED + 100 + k)."""
    return SEED + 100 + int(model_id[1:])


class MuxEncoderModel:
    """One loaded encoder's weights on the replica's card. ``unload`` drops
    them; ``checkpoint`` counts the call; both go to the replica's log."""

    def __init__(self, model_id: str, params: dict, owner):
        self.model_id, self.params, self.owner = model_id, params, owner

    def checkpoint(self):
        self.owner.log.append(("checkpoint", self.model_id))

    def unload(self):
        self.params = None
        self.owner.resident.pop(self.model_id, None)
        self.owner.log.append(("unload", self.model_id))


@serve.deployment(num_replicas=2, max_ongoing_requests=64, ray_actor_options={"num_gpus": 0.5})
class MuxEncoder:
    """Phase 23's encoder with one model a model id, at most MUX_PER_REPLICA
    loaded a replica (@serve.multiplexed); a request's batch runs one forward
    for each model id in it."""

    def __init__(self, config_kwargs: dict, device: str):
        self.config = TransformerConfig(**config_kwargs)
        self.device = device
        self.seq = min(BERT_SEQ, self.config.max_seq)
        self.log: list = []
        self.resident: dict = {}  # model id -> its weights' bytes
        self.max_resident = 0
        self.forwards = 0
        self.load_s: list = []
        # The most a forward allocated above what it found (activations,
        # and the first forward's cuBLAS workspace, which stays).
        self.forward_peak_bytes = 0

    @serve.multiplexed(max_num_models_per_replica=MUX_PER_REPLICA)
    async def get_model(self, model_id: str) -> MuxEncoderModel:
        start = time.perf_counter()
        params = init_params(self.config, seed=_mux_seed(model_id), device=self.device)
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.load_s.append(time.perf_counter() - start)
        self.log.append(("load", model_id))
        self.resident[model_id] = _model_bytes(params)
        return MuxEncoderModel(model_id, params, self)

    async def __call__(self, body):
        """A hit is a request whose model was loaded here when it came."""
        model_id = serve.get_multiplexed_model_id()
        hit = model_id in self.resident
        row = await self.batched((model_id, body))
        return {"embedding": row, "hit": hit, "pid": os.getpid()}

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.005)
    async def batched(self, items):
        groups: dict = {}
        for i, (model_id, _) in enumerate(items):
            groups.setdefault(model_id, []).append(i)
        out = [None] * len(items)
        for model_id, rows in groups.items():
            model = await self.get_model(model_id)
            # Past the load and its eviction: what this replica holds.
            self.max_resident = max(self.max_resident, len(self.resident))
            tokens = _bert_tokens([items[i][1] for i in rows], self.seq)
            if self.device == "cuda":
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
            with torch.inference_mode():
                logits = forward(model.params, torch.from_numpy(tokens).to(self.device),
                                 self.config)
            answers = logits[:, 0, :8].double().cpu().numpy()
            if self.device == "cuda":
                self.forward_peak_bytes = max(self.forward_peak_bytes,
                                              torch.cuda.max_memory_allocated() - before)
            self.forwards += 1
            for i, row in zip(rows, answers):
                out[i] = row.tolist()
        return out

    def stats(self, _):
        return {"pid": os.getpid(), "log": list(self.log), "forwards": self.forwards,
                "max_resident": self.max_resident, "resident": sorted(self.resident),
                "resident_bytes": sum(self.resident.values()),
                "forward_peak_bytes": self.forward_peak_bytes,
                "load_ms": [1e3 * s for s in self.load_s],
                "memory_allocated": (torch.cuda.memory_allocated() if self.device == "cuda"
                                     else 0)}


def _by_replica(handle, method: str, replicas: int = 2) -> dict:
    """{pid: the replica's answer to ``method``}, reaching each replica by a
    session id the ring sends there."""
    out = {}
    for i in range(256):
        answer = getattr(handle.options(session_id=f"replica-{i}"), method).remote(0).result(
            timeout=60)
        out.setdefault(answer["pid"], answer)
        if len(out) == replicas:
            return out
    raise AssertionError(f"{method}: sessions reached {len(out)} of {replicas} replicas")


def _metric_counts(metric: dict) -> tuple:
    """One replica's launch counts and flash routes, from its metrics."""
    kernels = metric["kernels"]
    return ({k: kernels[k]["launches"] for k in _counts()},
            {k: kernels[k]["launches_by_route"] for k in _route_counts()})


def _model_bytes(params: dict) -> int:
    leaves = [params["embed"], params["final_norm"], params["lm_head"],
              *params["layers"].values()]
    return sum(leaf.numel() * leaf.element_size() for leaf in leaves)


def phase_serve_mux(config_kwargs=None, device="cuda", seconds=MUX_SECONDS) -> dict:
    """Phase 27 (a): MuxEncoder's 2 replicas (num_gpus 0.5 each) under
    MUX_CLIENTS closed-loop clients in driver threads for `seconds`, each
    drawing a model id of MUX_MODELS by MUX_SHARES from its seeded generator
    and calling handle.options(multiplexed_model_id=...); then MUX_CHECKS
    seeded requests a model id. Every answer against a direct forward of
    that model's weights here; the replicas' LRU logs, the models they held,
    their memory and their launch counts against their forwards."""
    config_kwargs = config_kwargs or BERT_CONFIG
    config = TransformerConfig(**config_kwargs)
    encoder = MuxEncoder if device == "cuda" else MuxEncoder.options(ray_actor_options={})
    start = time.perf_counter()
    rt.init(num_cpus=8)
    controller = serve.start(http_port=None)
    try:
        handle = serve.run(encoder.bind(config_kwargs, device), name="mux", route_prefix="/mux")
        ready_s = time.perf_counter() - start
        by_model = {m: handle.options(multiplexed_model_id=m) for m in MUX_MODELS}
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def client(i: int) -> list:
            rng = np.random.default_rng(SEED + 27 + i)
            mine = []
            while time.perf_counter() < deadline:
                model_id = str(rng.choice(MUX_MODELS, p=MUX_SHARES))
                sent = time.perf_counter()
                answer = by_model[model_id].remote(HTTP_PAYLOAD).result(timeout=60)
                mine.append((model_id, time.perf_counter() - sent, answer))
            return mine

        with concurrent.futures.ThreadPoolExecutor(MUX_CLIENTS) as pool:
            results = [r for rs in pool.map(client, range(MUX_CLIENTS)) for r in rs]
        traffic_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED + 270)
        check_bodies = [{"token_ids": rng.integers(0, config.vocab_size, BERT_SEQ).tolist()}
                        for _ in range(MUX_CHECKS)]
        checks = {m: [by_model[m].remote(b).result(timeout=60)["embedding"]
                      for b in check_bodies] for m in MUX_MODELS}
        stats = _by_replica(handle, "stats")
        metrics = {m["pid"]: m
                   for m in _serve_metrics(controller, "mux_MuxEncoder", at_rest=True)}
    finally:
        _serve_down()

    # Each model's direct forward here.
    seq = min(BERT_SEQ, config.max_seq)
    bodies = [HTTP_PAYLOAD] + check_bodies
    direct, model_bytes = {}, 0
    for model_id in MUX_MODELS:
        params = init_params(config, seed=_mux_seed(model_id), device=device)
        model_bytes = _model_bytes(params)
        with torch.inference_mode():
            logits = forward(params, torch.from_numpy(_bert_tokens(bodies, seq)).to(device),
                             config)
            direct[model_id] = logits[:, 0, :8].double().cpu().numpy()
        del params, logits

    errs = [float(np.abs(np.asarray(a["embedding"]) - direct[m][0]).max())
            for m, _, a in results]
    errs += [float(np.abs(np.asarray(row) - direct[m][i + 1]).max())
             for m, rows in checks.items() for i, row in enumerate(rows)]
    hits = [lat for _, lat, a in results if a["hit"]]
    misses = [lat for _, lat, a in results if not a["hit"]]
    per_replica, counts_by_pid = {}, {}
    for pid, st in stats.items():
        events = st["log"]
        unloads = [i for i, e in enumerate(events) if e[0] == "unload"]
        per_replica[pid] = {
            "loads": sum(e[0] == "load" for e in events), "evictions": len(unloads),
            "checkpoint_then_unload": all(
                i > 0 and events[i - 1] == ("checkpoint", events[i][1]) for i in unloads),
            "max_models": st["max_resident"], "resident": st["resident"],
            "requests": sum(a["pid"] == pid for _, _, a in results),
            "forwards": st["forwards"],
            # The first load is the replica's first use of the card.
            "first_load_ms": st["load_ms"][0] if st["load_ms"] else None,
            "load_ms_median": (statistics.median(st["load_ms"][1:])
                               if len(st["load_ms"]) > 1 else None),
            "memory_allocated": st["memory_allocated"], "resident_bytes": st["resident_bytes"],
            "forward_peak_bytes": st["forward_peak_bytes"],
            # What the replica may hold after its evictions: 2 models, and
            # what its largest forward allocated above what it found.
            "memory_bound": MUX_PER_REPLICA * model_bytes + st["forward_peak_bytes"],
            "batches": metrics[pid]["batches"]}
        counts_by_pid[pid] = _metric_counts(metrics[pid])
    share = {}
    for model_id in MUX_MODELS:
        mine = [a["pid"] for m, _, a in results if m == model_id]
        share[model_id] = max(mine.count(p) for p in stats) / max(1, len(mine))
    result = dict(
        config="release/serve_bert_http.py non-tiny (BERT-base widths, bf16), multiplexed",
        models=list(MUX_MODELS), shares=list(MUX_SHARES), clients=MUX_CLIENTS,
        seconds=traffic_s, requests=len(results), qps=len(results) / traffic_s,
        hit_requests=len(hits), miss_requests=len(misses),
        hit_p50_ms=_percentile_ms(hits, 0.5) if hits else None,
        hit_p99_ms=_percentile_ms(hits, 0.99) if hits else None,
        miss_p50_ms=_percentile_ms(misses, 0.5) if misses else None,
        miss_p99_ms=_percentile_ms(misses, 0.99) if misses else None,
        replicas=per_replica, busiest_replica_share=share, model_bytes=model_bytes,
        max_answer_err=max(errs), answer_tol=LOGITS_TOL, ready_s=ready_s,
        phase_seconds=time.perf_counter() - start)
    log("serve_mux", **result)
    require(max(errs) < LOGITS_TOL,
            f"serve_mux: answers {max(errs)} from the direct forwards >= {LOGITS_TOL}")
    require(all(np.isfinite(d).all() for d in direct.values()), "serve_mux: non-finite logits")
    for pid, rep in per_replica.items():
        require(rep["max_models"] <= MUX_PER_REPLICA,
                f"serve_mux: replica {pid} held {rep['max_models']} models")
        require(rep["checkpoint_then_unload"], f"serve_mux: replica {pid}'s evictions {rep}")
        if device == "cuda":
            require(rep["memory_allocated"] <= rep["memory_bound"],
                    f"serve_mux: replica {pid} holds {rep['memory_allocated']} bytes after the "
                    f"run, above 2 models and its largest forward's ({rep['memory_bound']})")
    require(sum(rep["evictions"] for rep in per_replica.values()) > 0
            or len(MUX_MODELS) <= 2 * MUX_PER_REPLICA, "serve_mux: no eviction")
    result["counts_by_pid"] = counts_by_pid
    result["direct_forwards"] = len(MUX_MODELS)
    return result


def chaos_app():
    """The chaos bench's application, built when run_from_config imports it:
    phase 23's encoder at BERT-base widths on CHAOS_DEVICE."""
    return ChaosEncoder.bind(BERT_CONFIG, SEED, CHAOS_DEVICE)


# The bench's deployment (release/benchmarks_serve_chaos.py) around phase
# 23's encoder class; the YAML sets the rest.
ChaosEncoder = serve.deployment(name="ChaosEncoder", health_check_period_s=1.0)(
    BertEncoder.func_or_class)

CHAOS_YAML = """\
http_options: {{host: 127.0.0.1, port: {port}, num_proxies: 2}}
applications:
  - name: chaosbench
    route_prefix: /chaosbench
    import_path: {module}:chaos_app
    deployments:
      - name: ChaosEncoder
        num_replicas: 2
        max_ongoing_requests: 32
        request_timeout_s: 30
        retry_policy: {{max_attempts: 8, hedge: true}}
"""


def chaos_load(conn, ports: list, path: str, clients: int) -> None:
    """release/benchmarks_serve_chaos.py's clients, in a process of their
    own: each of `clients` threads posts logical requests back to back, to
    its own proxy first (client i to ports[i % 2]) and to the other on a
    connection error; a 503 waits its Retry-After and counts as shed; any
    other failure, or no answer within the window and 30 s, is lost. Each
    burst the parent asks for (("go", seconds, payload)) reports every
    request's start, latency and answer."""
    import http.client

    conn.send("ready")
    while True:
        command = conn.recv()
        if command[0] != "go":
            break
        _, seconds, payload = command
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        t0 = time.perf_counter()
        deadline = t0 + seconds
        lock = threading.Lock()
        out = {"results": [], "shed": 0, "lost": 0, "lost_detail": [], "failovers": 0,
               "answers": {}}

        def client(i: int) -> None:
            order = ports[i % len(ports):] + ports[:i % len(ports)]
            conns = {p: http.client.HTTPConnection("127.0.0.1", p, timeout=15) for p in order}
            while time.perf_counter() < deadline:
                start, outcome = time.perf_counter(), None
                while outcome is None and time.perf_counter() < deadline + 30:
                    for port in order:
                        try:
                            conns[port].request("POST", path, body=body, headers=headers)
                            resp = conns[port].getresponse()
                            data = resp.read()
                        except (OSError, http.client.HTTPException):
                            conns[port].close()
                            conns[port] = http.client.HTTPConnection("127.0.0.1", port,
                                                                     timeout=15)
                            with lock:
                                out["failovers"] += 1
                            continue
                        if resp.status == 200:
                            outcome = ("ok", data)
                            break
                        if resp.status == 503:
                            with lock:
                                out["shed"] += 1
                            time.sleep(float(resp.getheader("Retry-After", "0.2")))
                            continue
                        outcome = ("lost", f"HTTP {resp.status}: {data[:120]!r}")
                        break
                    else:
                        time.sleep(0.1)
                outcome = outcome or ("lost", "no 2xx before the window's end and 30 s")
                with lock:
                    if outcome[0] == "ok":
                        out["results"].append((start - t0, time.perf_counter() - start))
                        out["answers"][outcome[1]] = out["answers"].get(outcome[1], 0) + 1
                    else:
                        out["lost"] += 1
                        out["lost_detail"].append(outcome[1])
            for c in conns.values():
                c.close()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["answers"] = [(json.loads(d)["embedding"], n) for d, n in out["answers"].items()]
        out["seconds"] = time.perf_counter() - t0
        conn.send(out)


def _slowest(results: list, n: int = CHAOS_SLOWEST) -> list:
    """The ``n`` slowest of a load window's (start, latency) results, as
    [start s, latency ms], slowest first."""
    return [[round(at, 3), round(1e3 * lat, 2)]
            for at, lat in sorted(results, key=lambda r: -r[1])[:n]]


def _port_pair() -> int:
    """A port whose next one is free too (the second proxy's)."""
    while True:
        port = _bert_port()
        with socket.socket() as probe:
            try:
                probe.bind(("127.0.0.1", port + 1))
                return port
            except OSError:
                continue


def phase_serve_chaos(seconds=CHAOS_SECONDS) -> dict:
    """Phase 27 (b): release/benchmarks_serve_chaos.py's phases 1 and 2 on
    the card. The YAML above (BERT-base encoder, 2 replicas, hedging on,
    two proxies) through serve.run_from_config; CHAOS_CLIENTS clients in a
    process of their own for a `seconds` baseline, then a `seconds` window
    in which one replica's process and the second proxy's are SIGKILLed;
    then the wait for the controller to replace the replica and restart the
    proxy on its port. The bench's gates: nothing lost, both kills landed,
    both recovered, the chaos p99 under 3x the baseline's."""
    import torch.multiprocessing as mp

    start = time.perf_counter()
    SERVE_SCRATCH.mkdir(parents=True, exist_ok=True)
    port = _port_pair()
    ports = [port, port + 1]
    path = SERVE_SCRATCH / "chaos.yaml"
    yaml_text = CHAOS_YAML.format(port=port, module=chaos_app.__module__)
    if CHAOS_DEVICE == "cuda":
        yaml_text += "        ray_actor_options: {num_gpus: 0.5}\n"
    path.write_text(yaml_text)
    qname = "chaosbench_ChaosEncoder"
    # The clients' process starts beside the deployment's replicas and
    # proxies, one wave of process starts instead of two; it sends nothing
    # before its first "go".
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    loader = ctx.Process(target=chaos_load, args=(child, ports, "/chaosbench", CHAOS_CLIENTS))
    loader.start()
    rt.init(num_cpus=8)
    try:
        deployed = serve.run_from_config(str(path))
        ready_s = time.perf_counter() - start
        controller = serve.start(http_port=None)
        require(deployed == {"chaosbench": "ChaosEncoder"}, f"serve_chaos: deployed {deployed}")
        proxies = {p["port"]: p for p in _ctl(controller, "get_proxies")}
        require(sorted(proxies) == ports and proxies[port + 1]["pid"],
                f"serve_chaos: proxies {proxies}")

        def running() -> int:
            return serve.status()["chaosbench"]["deployments"]["ChaosEncoder"][
                "running_replicas"]

        try:
            require(parent.poll(120) and parent.recv() == "ready", "serve_chaos: load generator")

            def burst(during=None) -> dict:
                parent.send(("go", seconds, HTTP_PAYLOAD))
                extra = during() if during else None
                require(parent.poll(seconds + 120), "serve_chaos: the load generator went silent")
                out = parent.recv()
                out["during"] = extra
                return out

            baseline = burst()
            victims = sorted(m["pid"] for m in _ctl(controller, "get_metrics")[qname])
            proxy_pid = proxies[port + 1]["pid"]

            def kills() -> list:
                events, t0 = [], time.perf_counter()
                for at, pid, what in ((CHAOS_REPLICA_KILL_S, victims[0], "replica"),
                                      (CHAOS_PROXY_KILL_S, proxy_pid, "proxy")):
                    time.sleep(max(0.0, at - (time.perf_counter() - t0)))
                    try:
                        os.kill(pid, signal.SIGKILL)
                        events.append({"target": what, "pid": pid, "status": "ok",
                                       "at_s": time.perf_counter() - t0})
                    except ProcessLookupError:
                        events.append({"target": what, "pid": pid, "status": "gone"})
                return events

            chaos = burst(kills)
            parent.send(("stop",))
        finally:
            loader.join(30)
            if loader.is_alive():
                loader.kill()
        recover_start = time.perf_counter()
        recovered = proxy_back = False
        while time.perf_counter() - recover_start < CHAOS_RECOVER_S:
            pids = {m["pid"] for m in _ctl(controller, "get_metrics").get(qname, [])}
            recovered = running() == 2 and victims[0] not in pids and len(pids) == 2
            now = next(p for p in _ctl(controller, "get_proxies") if p["port"] == port + 1)
            try:
                proxy_back = now["restarts"] == 1 and _post_json(
                    port + 1, "/chaosbench", HTTP_PAYLOAD)["embedding"] is not None
            except (OSError, AssertionError):
                proxy_back = False
            if recovered and proxy_back:
                break
            time.sleep(0.5)
        recover_s = time.perf_counter() - recover_start
        reliability = [_ctl(controller, "proxy_call", f"SERVE_PROXY::{p}",
                            "get_reliability_stats") for p in ports]
        route_p99 = _ctl(controller, "get_route_p99").get(qname)
        metrics = _serve_metrics(controller, qname, at_rest=True)
    finally:
        if loader.is_alive():
            loader.kill()
        _serve_down()
        shutil.rmtree(SERVE_SCRATCH, ignore_errors=True)

    config = TransformerConfig(**BERT_CONFIG)
    params = init_params(config, seed=SEED, device=CHAOS_DEVICE)
    with torch.inference_mode():
        direct = forward(params, torch.from_numpy(
            _bert_tokens([HTTP_PAYLOAD], min(BERT_SEQ, config.max_seq))).to(CHAOS_DEVICE),
            config)[:, 0, :8].double().cpu().numpy()[0]
    del params
    errs = [float(np.abs(np.asarray(emb) - direct).max())
            for b in (baseline, chaos) for emb, _ in b["answers"]]
    base_lat = [lat for _, lat in baseline["results"]]
    chaos_lat = [lat for _, lat in chaos["results"]]
    events = chaos["during"]
    hedges = {k: sum((r or {}).get(k, 0) for r in reliability)
              for k in ("hedges_launched", "hedges_won", "hedges_lost", "hedges_skipped",
                        "retries", "attempt_deaths")}
    # A ChaosEncoder replica's forwards: its batches and its warm-up.
    counts_by_pid = {m["pid"]: (*_metric_counts(m), m["batches"] + len(BUCKETS))
                     for m in metrics}
    result = dict(
        config="release/benchmarks_serve_chaos.py phases 1-2, BERT-base encoder, YAML deploy",
        clients=CHAOS_CLIENTS, seconds=seconds, ready_s=ready_s,
        lost=baseline["lost"] + chaos["lost"], baseline_lost=baseline["lost"],
        lost_detail=(baseline["lost_detail"] + chaos["lost_detail"])[:5],
        shed=baseline["shed"] + chaos["shed"],
        failovers=baseline["failovers"] + chaos["failovers"],
        replica_kills=sum(e["status"] == "ok" and e["target"] == "replica" for e in events),
        proxy_kills=sum(e["status"] == "ok" and e["target"] == "proxy" for e in events),
        kills=events, replicas_recovered=int(recovered), proxy_restarted=int(proxy_back),
        recover_s=recover_s,
        baseline_requests=len(base_lat), chaos_requests=len(chaos_lat),
        baseline_qps=len(base_lat) / baseline["seconds"],
        chaos_qps=len(chaos_lat) / chaos["seconds"],
        baseline_p50_ms=_percentile_ms(base_lat, 0.5), baseline_p99_ms=_percentile_ms(base_lat, 0.99),
        chaos_p50_ms=_percentile_ms(chaos_lat, 0.5), chaos_p99_ms=_percentile_ms(chaos_lat, 0.99),
        p99_ratio=_percentile_ms(chaos_lat, 0.99) / _percentile_ms(base_lat, 0.99),
        # Where the tails lie: the slowest requests of each window, as
        # (seconds from the window's start, latency ms).
        baseline_slowest=_slowest(baseline["results"]), chaos_slowest=_slowest(chaos["results"]),
        **hedges, breaker_states_seen=sorted({s for r in reliability if r
                                              for s in r["breaker_states_seen"]}),
        # The second proxy's counts start again at its restart.
        by_proxy=dict(zip(map(str, ports), reliability)),
        route_p99_ms=route_p99, max_answer_err=max(errs), answer_tol=LOGITS_TOL,
        drain_ok="not run: the oom_risk drain waits for the node agent's telemetry (ROADMAP "
                 "Queue A item 14d)",
        replicas_after=sorted(counts_by_pid), phase_seconds=time.perf_counter() - start)
    log("serve_chaos", **result)
    require(result["lost"] == 0, f"serve_chaos: {result['lost']} lost: {result['lost_detail']}")
    require(result["replica_kills"] >= 1 and result["proxy_kills"] >= 1,
            f"serve_chaos: kills {events}")
    require(result["replicas_recovered"] == 1, "serve_chaos: the killed replica not replaced")
    require(result["proxy_restarted"] == 1, "serve_chaos: the killed proxy not restarted")
    require(result["p99_ratio"] < 3, f"serve_chaos: p99 ratio {result['p99_ratio']}")
    require(max(errs) < LOGITS_TOL,
            f"serve_chaos: answers {max(errs)} from the direct forward >= {LOGITS_TOL}")
    result["counts_by_pid"] = counts_by_pid
    return result


# ---------------------------------------------------------------- phase 28
# Compiled graphs (ray_tpu_torch.dag) on the port's local actors: (a) the
# two-stage pipeline of TransformerConfig.llama2_7b() at DAG_LAYERS layers
# on device edges, two
# actors at half of the card each; (b) release/benchmarks_dag.py's hop and
# rpc phases; (c) release/benchmarks_dag_recovery.py's supervised chain.
DAG_BATCH, DAG_SEQ = 8, 512
DAG_STAGES = 2
# llama2_7b()'s depth in (a), cut from 32 layers to 8 (4 a stage) to keep
# the script inside its time limit; every check holds at any depth.
DAG_LAYERS = 8
DAG_INPUTS = 4           # distinct token batches, each held against the driver's chain
DAG_PIPELINED = 16       # executions with up to CHANNEL_DEPTH in flight
DAG_SEQUENTIAL = 16      # executions each followed by its get
DAG_DRIVER_REPS = 5      # the driver's own chain, timed
DAG_TRACED = 3           # executions after the warm one, each under a driver span
DAG_HOP_BYTES = 4 << 20  # release/benchmarks_dag.py's full payload: 1 << 20 float32
DAG_HOP_REPS, DAG_HOP_WARM = 80, 4
DAG_RPC_STEPS = 100
DAG_STEADY_STEPS = 100   # release/benchmarks_dag_recovery.py's full scale
DAG_CHAOS_PRE, DAG_CHAOS_STREAM = 4, 60
DAG_START_TIMEOUT_S = 300.0


def _dag_config(config: TransformerConfig) -> dict:
    return {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}


def _dag_started(handles: list, spawned: float) -> list:
    """Futures of each actor's seconds from its spawn to ALIVE (its
    constructor run), each waited for in a thread of its own from now."""
    def wait(h):
        info = local_tasks.actor_info(h._actor_id, wait_ready=True, timeout=DAG_START_TIMEOUT_S)
        require(info["state"] == "ALIVE", f"dag: actor {h} did not start: {info}")
        return time.perf_counter() - spawned

    pool = concurrent.futures.ThreadPoolExecutor(len(handles))
    futures = [pool.submit(wait, h) for h in handles]
    pool.shutdown(wait=False)
    return futures


def _dag_stage_want(stage: int, executions: int, config: TransformerConfig) -> dict:
    """One stage actor's launches: a flash forward a layer, two norms a
    layer, and the final norm on the last stage, per execution."""
    layers = config.n_layers // DAG_STAGES
    norms = 2 * layers + (1 if stage == DAG_STAGES - 1 else 0)
    return {"flash_attention_fwd": layers * executions, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "rmsnorm": norms * executions, "rmsnorm_bwd": 0}


def _dag_pipeline(config: TransformerConfig, stages: list, device: str) -> dict:
    """Phase 28 (a): the compiled pipeline against the driver's chain."""
    rng = np.random.default_rng(SEED + 28)
    inputs = [torch.from_numpy(rng.integers(0, config.vocab_size, (DAG_BATCH, DAG_SEQ))).to(device)
              for _ in range(DAG_INPUTS)]
    t0 = time.perf_counter()
    params = init_params(config, seed=SEED, device=device)
    parts = partition_stages(params, config, DAG_STAGES)
    sums = [dag_apps.leaf_checksums(p) for p in parts]
    params_s = time.perf_counter() - t0

    def chain(tokens):
        with torch.inference_mode():
            x = tokens
            for s, tree in enumerate(parts):
                x = stage_forward(tree, x, config, first=s == 0, last=s == DAG_STAGES - 1)
            return x[:, -1, :].contiguous()

    want = [chain(t) for t in inputs]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(DAG_DRIVER_REPS):
        chain(inputs[i % DAG_INPUTS])
    _sync(device)
    driver_s = (time.perf_counter() - t0) / DAG_DRIVER_REPS
    driver_forwards = DAG_INPUTS + DAG_DRIVER_REPS

    got_sums = local_tasks.get([s.checksums.remote() for s in stages], timeout=600)
    for s in range(DAG_STAGES):
        require(got_sums[s] == sums[s], f"dag: stage {s}'s leaves differ from the driver's "
                                        f"partition: {got_sums[s]} vs {sums[s]}")
    del params, parts
    if device == "cuda":
        torch.cuda.empty_cache()
    local_tasks.get([s.reset_counts.remote() for s in stages], timeout=60)

    t0 = time.perf_counter()
    with InputNode() as inp:
        out = stages[1].forward.bind(stages[0].forward.bind(inp))
    dag = out.experimental_compile(channel="device")
    compile_s = time.perf_counter() - t0
    outs: list = []
    before = _counts()
    try:
        t0 = time.perf_counter()
        outs.append((0, dag.execute(inputs[0]).get(timeout=600)))  # warm: first IPC opens
        first_s = time.perf_counter() - t0
        traced_runs = []
        for k in range(DAG_TRACED):
            with tracing.span("dag.execute", execution=k) as root:
                injected = tracing.inject()
                outs.append((k % DAG_INPUTS, dag.execute(inputs[k % DAG_INPUTS]).get(timeout=600)))
            traced_runs.append({"trace_id": root.trace_id, "span_id": root.span_id,
                                "inject": injected,
                                "last_trace": dag._out_readers[0]._chan.last_trace})
        t0 = time.perf_counter()
        refs: dict = {}
        done = 0
        while done < DAG_PIPELINED:
            while len(refs) < dag.CHANNEL_DEPTH and done + len(refs) < DAG_PIPELINED:
                k = done + len(refs)
                refs[k] = dag.execute(inputs[k % DAG_INPUTS])
            outs.append((done % DAG_INPUTS, refs.pop(done).get(timeout=600)))
            done += 1
        pipelined_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for k in range(DAG_SEQUENTIAL):
            outs.append((k % DAG_INPUTS, dag.execute(inputs[k % DAG_INPUTS]).get(timeout=600)))
        sequential_s = time.perf_counter() - t0
    finally:
        dag.close()
    require(_counts() == before, f"dag: the driver launched {_counts()} during the executions")
    executions = len(outs)
    errs = [max_err(o, want[i]) for i, o in outs]
    bitwise = all(torch.equal(o, want[i]) for i, o in outs)
    require(all(o.shape == (DAG_BATCH, config.vocab_size) and o.dtype == torch.float32
                and bool(torch.isfinite(o).all()) for _, o in outs),
            "dag: outputs of the wrong shape or type, or not finite")
    require(bitwise or max(errs) < LOGITS_TOL,
            f"dag: logits differ from the driver's chain by {max(errs)}")
    by_actor = local_tasks.get([s.counts.remote() for s in stages], timeout=60)
    infos = local_tasks.get([s.info.remote() for s in stages], timeout=60)
    tokens = DAG_BATCH * DAG_SEQ
    return {
        "executions": executions, "driver_forwards": driver_forwards,
        "bitwise_equal": bitwise, "max_abs_err": max(errs), "tol": LOGITS_TOL,
        "pipelined_tokens_per_s": DAG_PIPELINED * tokens / pipelined_s,
        "sequential_tokens_per_s": DAG_SEQUENTIAL * tokens / sequential_s,
        "driver_tokens_per_s": tokens / driver_s,
        "pipelined_s": pipelined_s, "sequential_s": sequential_s, "driver_chain_s": driver_s,
        "first_execution_s": first_s, "compile_s": compile_s, "driver_params_s": params_s,
        "actors": [{**info, "counts": c, "routes": r} for info, (c, r) in zip(infos, by_actor)],
        "traced_runs": traced_runs,
    }


def _dag_trace_check(session: str, runs: list, stage_pids: list) -> dict:
    """Phase 28 (a)'s traced executions: each one trace id from the
    driver's span through the input edge, both stage actors' stage spans,
    the CUDA edge between them (its push in stage 0's process, its pop in
    stage 1's, under that push) and the output edge, whose context the
    driver's reader holds (last_trace)."""
    wanted = {r["trace_id"] for r in runs}

    def ready(spans):
        got = [s for s in spans if s["trace_id"] in wanted]
        return sum(s["name"] == "channel.pop" for s in got) >= 3 * len(wanted)

    spans = _spans_when(session, ready)
    out = []
    for run in runs:
        mine = [s for s in spans if s["trace_id"] == run["trace_id"]]
        by_name: dict = {}
        for s in mine:
            by_name.setdefault(s["name"], []).append(s)
        pushes, pops = by_name.get("channel.push", []), by_name.get("channel.pop", [])
        stage_spans = by_name.get("dag.stage forward", [])
        push_by_pid = {s["pid"]: s for s in pushes}
        cuda_push = push_by_pid.get(stage_pids[0])
        cuda_pop = next((p for p in pops if p["pid"] == stage_pids[1] and cuda_push
                         and p["parent_id"] == cuda_push["span_id"]), None)
        check = {
            "trace_id": run["trace_id"],
            "inject": run["inject"] == {"trace_id": run["trace_id"], "span_id": run["span_id"]},
            "pushes": len(pushes), "pops": len(pops),
            "stage_pids": sorted(s["pid"] for s in stage_spans),
            "cuda_edge": bool(cuda_push and cuda_pop
                              and cuda_push["attributes"]["family"] == "device"),
            "pops_under_pushes": all(p["parent_id"] in {q["span_id"] for q in pushes}
                                     for p in pops),
            "last_trace": (run["last_trace"] or {}).get("trace_id") == run["trace_id"],
        }
        check["ok"] = (check["inject"] and len(pushes) == 3 and len(pops) == 3
                       and check["stage_pids"] == sorted(stage_pids) and check["cuda_edge"]
                       and check["pops_under_pushes"] and check["last_trace"])
        out.append(check)
    return {"executions": out, "spans": _span_counts(spans)}


def _dag_echo_hop(actor, payload, reps: int = DAG_HOP_REPS) -> float:
    """Half the median round trip of a 1-stage echo graph on device edges."""
    with InputNode() as inp:
        out = actor.echo.bind(inp)
    dag = out.experimental_compile(channel="device")
    try:
        for _ in range(DAG_HOP_WARM):
            dag.execute(payload).get(timeout=120)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            back = dag.execute(payload).get(timeout=120)
            times.append(time.perf_counter() - t0)
        require(tuple(back.shape) == tuple(payload.shape), "dag hop: the echo changed the payload")
    finally:
        dag.close()
    return statistics.median(times) / 2.0


def _dag_raw_hop(actor, cuda: bool, device: str) -> float:
    """Half the median round trip of the raw exchange with ``actor`` on a
    two-rank DeviceGroup: gloo send/recv of the float32 tensor, or (cuda)
    the same IPC exchange a device edge makes, without loop or framing."""
    from ray_tpu_torch.dag import channels

    store = channels.host_store()
    name = f"raw-hop-{os.getpid()}-{time.monotonic_ns()}"
    reps = DAG_HOP_REPS + DAG_HOP_WARM
    peer = actor.pingpong.remote(store.port, name, DAG_HOP_BYTES, reps, cuda)
    group = channels.DeviceGroup(store, name, 0, 2)
    times = []
    if cuda:
        payload = torch.ones(DAG_HOP_BYTES // 4, dtype=torch.float32, device=device)
        cache: dict = {}
        for _ in range(reps):
            t0 = time.perf_counter()
            body, held, _ = channels.encode(group, 1, payload)
            group.send_frame(1, 1, channels.VALUE, body)
            group.recv_frame(1, 2)
            _, reply = group.recv_frame(1, 1)
            value, dec = channels.decode(group, 1, reply, cache)
            for done in dec.copies:
                done.synchronize()
            group.send_frame(1, 2, channels.ACK)
            times.append(time.perf_counter() - t0)
            del held, value
    else:
        buf = torch.ones(DAG_HOP_BYTES // 4, dtype=torch.float32)
        for _ in range(reps):
            t0 = time.perf_counter()
            group.gloo.send([buf], 1, 1).wait()
            group.gloo.recv([buf], 1, 1).wait()
            times.append(time.perf_counter() - t0)
    local_tasks.get(peer, timeout=120)
    return statistics.median(times[DAG_HOP_WARM:]) / 2.0


def _dag_hop(actor, device: str) -> dict:
    """Phase 28 (b) hop: the echo graph against the raw exchange, host
    float32 and (on the card) a CUDA tensor of the same bytes, and the
    pipeline's 32 MiB hidden state through the echo."""
    host = np.ones(DAG_HOP_BYTES // 4, dtype=np.float32)
    out = {"payload_bytes": DAG_HOP_BYTES}
    raw, dag = _dag_raw_hop(actor, False, device), _dag_echo_hop(actor, host)
    out["host"] = {"raw_hop_us": raw * 1e6, "dag_hop_us": dag * 1e6,
                   "hop_overhead_pct": (dag - raw) / raw * 100.0}
    if device == "cuda":
        card = torch.ones(DAG_HOP_BYTES // 4, dtype=torch.float32, device=device)
        raw, dag = _dag_raw_hop(actor, True, device), _dag_echo_hop(actor, card)
        out["cuda"] = {"raw_hop_us": raw * 1e6, "dag_hop_us": dag * 1e6,
                       "hop_overhead_pct": (dag - raw) / raw * 100.0}
        hidden = torch.ones(DAG_BATCH, DAG_SEQ, 4096, dtype=torch.bfloat16, device=device)
        out["hidden_32mib_hop_us"] = _dag_echo_hop(actor, hidden, reps=20) * 1e6
    return out


def _dag_rpc(relays: list) -> dict:
    """Phase 28 (b) rpc: three relays driven by ordinary calls, then the
    same actors compiled onto shm channels; the messages this process sends
    to actors per step."""
    a, b, c = relays

    def chain_step(i):
        v = i
        for actor in (a, b, c):
            v = local_tasks.get(actor.add.remote(v), timeout=60)
        return v

    for i in range(3):
        chain_step(i)
    m0 = local_tasks.actor_messages()
    for i in range(DAG_RPC_STEPS):
        require(chain_step(i) == i + 3, "dag rpc: the chain's sum")
    task_messages = local_tasks.actor_messages() - m0
    with InputNode() as inp:
        out = c.add.bind(b.add.bind(a.add.bind(inp)))
    dag = out.experimental_compile(channel="shm")
    try:
        dag.execute(0).get(timeout=60)
        m0 = local_tasks.actor_messages()
        for i in range(DAG_RPC_STEPS):
            require(dag.execute(i).get(timeout=60) == i + 3, "dag rpc: the graph's sum")
        dag_messages = local_tasks.actor_messages() - m0
    finally:
        dag.close()
    require(dag_messages == 0, f"dag rpc: {dag_messages} messages to actors after compile")
    return {"steps": DAG_RPC_STEPS, "task_messages_per_step": task_messages / DAG_RPC_STEPS,
            "dag_messages_per_step": dag_messages / DAG_RPC_STEPS,
            "dag_actor_calls_per_step": dag_messages / DAG_RPC_STEPS}


def _dag_median_step_us(dag, steps: int) -> float:
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        require(dag.execute(i).get(timeout=60) == i + 3, "dag recovery: a step's sum")
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def _dag_recovery(baseline: list, supervised: list) -> dict:
    """Phase 28 (c): release/benchmarks_dag_recovery.py: an unsupervised
    3-relay shm chain's step, the same shape supervised, then the middle
    relay killed with a full window (CHANNEL_DEPTH) in flight."""
    def chain(relays, **kw):
        a, b, c = relays
        with InputNode() as inp:
            out = c.add.bind(b.add.bind(a.add.bind(inp)))
        return out.experimental_compile(channel="shm", **kw)

    base = chain(baseline)
    try:
        base.execute(0).get(timeout=60)
        baseline_us = _dag_median_step_us(base, DAG_STEADY_STEPS)
    finally:
        base.close()
    dag = chain(supervised, supervise=True)
    try:
        dag.execute(0).get(timeout=60)
        m0 = local_tasks.actor_messages()
        supervised_us = _dag_median_step_us(dag, DAG_STEADY_STEPS)
        steady_messages = local_tasks.actor_messages() - m0
        for i in range(DAG_CHAOS_PRE):
            require(dag.execute(i).get(timeout=60) == i + 3, "dag recovery: a warm step")
        start, stop = DAG_CHAOS_PRE, DAG_CHAOS_PRE + DAG_CHAOS_STREAM
        window = dag.CHANNEL_DEPTH
        refs = {i: dag.execute(i) for i in range(start, start + window)}
        local_tasks.kill(supervised[1])
        time.sleep(0.3)
        submitted, results = start + window, {}
        while refs:
            seq = min(refs)
            results[seq] = refs.pop(seq).get(timeout=180)
            if submitted < stop:
                refs[submitted] = dag.execute(submitted)
                submitted += 1
        lost = sum(1 for i in range(start, stop) if results.get(i) != i + 3)
        dups = sum(len(r._ready) for r in dag._out_readers)
        rec = dag.last_recovery or {}
        result = {"steps": DAG_CHAOS_STREAM, "window": window, "lost_outputs": lost,
                  "dup_outputs": dups, "recoveries": dag.recoveries,
                  "recovery_latency_s": rec.get("duration_s"), "recovery_epoch": rec.get("epoch"),
                  "victim_ranks": rec.get("victim_ranks"), "replay_discards": dag.replay_discards,
                  "baseline_step_us": baseline_us, "supervised_step_us": supervised_us,
                  "supervise_overhead_pct": (supervised_us - baseline_us) / baseline_us * 100.0,
                  "dag_actor_messages": steady_messages}
    finally:
        dag.close()
    require(result["lost_outputs"] == 0 and result["dup_outputs"] == 0
            and result["recoveries"] == 1, f"dag recovery: gates failed {result}")
    require(steady_messages == 0, f"dag recovery: {steady_messages} messages in the steady state")
    return result


def _dag_paths(pipeline: dict, local: dict, config: TransformerConfig) -> tuple:
    """Holds phase 28 (a)'s launches: none in this process but its own
    chains, each stage actor's to its layers, every flash launch on the
    wgmma route; returns the actors' counts and routes summed."""
    require(local == _expected(config.n_layers, kernel_forwards=pipeline["driver_forwards"]),
            f"dag: this process launched {local}, its own chains' worth expected")
    executions = pipeline["executions"]
    counts = {k: 0 for k in local}
    routes = {k: {"wgmma": 0, "mma_sync": 0}
              for k in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    for s, actor in enumerate(pipeline["actors"]):
        _path(f"dag[stage{s}]", _dag_stage_want(s, executions, config), actor["counts"],
              actor["routes"], "wgmma", executions=executions)
        for k, n in actor["counts"].items():
            counts[k] += n
        for k, by_route in actor["routes"].items():
            for r, n in by_route.items():
                routes[k][r] += n
    _path("dag", _expected(config.n_layers, kernel_forwards=executions), counts, routes,
          "wgmma", executions=executions)
    return counts, routes


def phase_dag(config: TransformerConfig | None = None, device: str = "cuda") -> dict:
    """Phase 28: compiled graphs on the port's local actors; every actor
    starts at once at the phase's start, and every process it started is
    stopped at its end."""
    config = config or TransformerConfig.llama2_7b(n_layers=DAG_LAYERS)
    start = time.perf_counter()
    if device == "cuda":
        torch.cuda.empty_cache()
    free_before = resources.available_resources()
    stage_cls = local_tasks.remote(dag_apps.TransformerStage)
    if device == "cuda":
        stage_cls = stage_cls.options(num_gpus=1.0 / DAG_STAGES)
    relay_cls = local_tasks.remote(dag_apps.Relay)
    try:
        spawned = time.perf_counter()
        # The stage actors start traced: phase 28 (a)'s traced executions
        # need their spans. The relays start beside them; (b) and (c) run
        # no span (no context flows into their graphs).
        with traced("dag") as session:
            stages = [stage_cls.remote(_dag_config(config), s, DAG_STAGES, seed=SEED,
                                       device=device, last_position=True)
                      for s in range(DAG_STAGES)]
            relays = [relay_cls.remote() for _ in range(9)]
            stage_starts = _dag_started(stages, spawned)
            relay_starts = _dag_started(relays, spawned)
            pipeline = _dag_pipeline(config, stages, device)
        stage_pids = [a["pid"] for a in pipeline["actors"]]
        trace_check = _dag_trace_check(session, pipeline.pop("traced_runs"), stage_pids)
        shutil.rmtree(session, ignore_errors=True)
        OBSERVABILITY["dag"] = trace_check
        log("dag_trace", **trace_check)
        require(all(c["ok"] for c in trace_check["executions"]),
                f"dag: traced executions {trace_check['executions']}")
        pipeline["actor_start_s"] = [f.result() for f in stage_starts]
        pipeline["relay_start_s"] = max(f.result() for f in relay_starts)
        log("dag_pipeline", **{k: v for k, v in pipeline.items() if k != "actors"},
            actors=[{k: v for k, v in a.items() if k not in ("counts", "routes")}
                    for a in pipeline["actors"]])
        hop = _dag_hop(stages[1], device)
        log("dag_hop", **hop)
        rpc = _dag_rpc(relays[:3])
        log("dag_rpc", **rpc)
        recovery = _dag_recovery(relays[3:6], relays[6:])
        log("dag_recovery", **recovery)
    finally:
        local_tasks.shutdown()
    require(resources.available_resources() == free_before,
            f"dag: leases outlived the actors: {resources.available_resources()} vs {free_before}")
    result = {"pipeline": pipeline, "hop": hop, "rpc": rpc, "recovery": recovery,
              "seconds": time.perf_counter() - start}
    log("dag", seconds=result["seconds"])
    return result


# ---------------------------------------------------------------- main
# ---------------------------------------------------------------- phase 29: the ring
RING_WORKERS = 2
RING_LAYERS = SHARDED_CONFIG["n_layers"]
RING_BATCH = 4                 # rows of max_seq + 1 tokens each rank trains on
# The exact run's steps, cut from 3 to 2 (8 s each) to keep the script
# inside its time limit; the bitwise checks hold at every step.
RING_EXACT_STEPS, RING_QUANT_STEPS = 2, 6
RING_SAMPLE = 1 << 20          # seeded indices of the flat gradient held bitwise
RING_CODEC_SLICE = 64 << 20    # elements of the codec's input held against numpy
RING_BLOCK = 256
# The quantized runs' steps 1-3 against the exact wire's (step 1 takes the
# same parameters and batch, so its loss is the same bits): the int8 and
# fp8 gradients with error feedback move two AdamW steps' loss by well
# under this share.
RING_LOSS_REL_TOL = 2e-2
RING_WIRE_RATIO = 0.3          # a quantized step's wire bytes against the exact one's
RING_STORAGE = Path(__file__).resolve().parent / "build" / "chip_smoke_ring"
# The int8 run is traced, and rank 1 arms a windowed chaos latency point on
# its allreduces at the start of RING_STALL_STEP (the schedule of
# tests/test_hang_doctor.py:399-413, scaled down): each allreduce it enters
# in the window (the overlap runs a few at once) waits RING_STALL_MS before
# its flight record, and the window closes before they wake. Under the
# watchdog's 2 s floor, so no stall is flagged.
RING_STALL_STEP, RING_STALL_MS, RING_STALL_WINDOW_S = 3, 1000.0, 1.0
# Flight-record kinds of user-visible ops (the ring's hops record send and
# recv inside them).
RING_OP_KINDS = ("allreduce", "allreduce_sharded", "allgather", "reducescatter", "broadcast",
                 "barrier")
# bench.py --overlap: 5 timed steps, buckets of 2 MiB over its ~14 MB tree.
OVERLAP_STEPS, OVERLAP_BUCKET_BYTES = 5, 2 << 20


def _ring_tokens(rank: int, config: TransformerConfig) -> torch.Tensor:
    """Rank ``rank``'s batch: RING_BATCH rows of max_seq + 1 seeded tokens,
    the same every step, so that the loss falls."""
    rng = np.random.default_rng(SEED + 2900 + rank)
    return torch.from_numpy(rng.integers(0, config.vocab_size,
                                         (RING_BATCH, config.max_seq + 1)))


def ring_loop(loop_config: dict) -> None:
    """The ring gang's train_loop_per_worker: setup_sharded_training on the
    session's {dp 2} mesh and build_sharded_train_step over the gang's ring
    group (the split step: fwd, bwd, grad_sync, opt), on this rank's own
    batch. After each step the ranks allgather their step's record over the
    ring, and rank 0's report carries both: the loss, seconds and split,
    the parameters' digest, the bytes the group sent during the step, the
    kernel launch counts since the loop began, and at the last step the
    run's stall count, wire_stats and peak memory. With ``spy`` the group's
    allreduce is watched: each record then holds the rank's flat gradient
    and the synced mean at RING_SAMPLE seeded indices. ``config`` (model
    kwargs) and ``device`` default to the ring config on the card; a CPU
    rehearsal passes a tiny config and "cpu" (no launch counts there)."""
    reset_counts()
    ctx = session_mod.get_context()
    device = loop_config.get("device", "cuda")
    cuda = device == "cuda"
    config = TransformerConfig(**loop_config.get(
        "config", {**SHARDED_CONFIG, "n_layers": RING_LAYERS}))
    setup = setup_sharded_training(lambda dev: init_params(config, seed=SEED, device=dev),
                                   make_optimizer, logical_dims=param_logical_dims(config))
    group = collective_mod.get_group(ctx.collective_group)
    require(group.backend_name == "ring", f"ring loop: the gang's group is {group.backend_name}")

    def batch_loss(params, tok):
        return loss_fn(params, tok[:, :-1], tok[:, 1:], config)

    step = build_sharded_train_step(batch_loss, setup, group_name=ctx.collective_group)
    total = sum(leaf.numel() for _, leaf in named_leaves(setup.params))
    samples: list = []
    if loop_config.get("spy"):
        gen = torch.Generator(device=device).manual_seed(SEED + 29)
        idx = torch.randint(0, total, (RING_SAMPLE,), generator=gen, device=device)
        inner = group.allreduce

        def spy(array, op="sum", tag="__ar"):
            out = inner(array, op=op, tag=tag)
            if isinstance(array, torch.Tensor) and array.numel() == total:
                samples.append((array[idx].cpu().numpy(),
                                (out / group.world_size)[idx].cpu().numpy()))
            return out

        group.allreduce = spy
    # The mesh's shard_batch cuts rank r's rows out of the global batch.
    tokens = torch.cat([_ring_tokens(r, config) for r in range(ctx.world_size)]).to(device)
    params, opt = setup.params, setup.opt_state
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    steps = loop_config["steps"]
    stall = loop_config.get("stall")
    stall_epoch = None
    for i in range(steps):
        if stall and i + 1 == stall["step"] and ctx.world_rank == 1:
            sched = FaultSchedule(seed=14, latency_points={"collective.allreduce.rank1": {
                "extra_ms": stall["extra_ms"], "start_s": 0.0,
                "duration_s": stall["duration_s"]}})
            stall_epoch = sched.epoch
            chaos_mod.install(sched, identity="ring-rank1", log_dir=stall["log_dir"],
                              export_env=False)
        if cuda:
            torch.cuda.synchronize()
        sent = group.wire_stats["bytes_sent"]
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens)
        mine = {"loss": float(loss), "step_s": time.perf_counter() - t0,
                "split": dict(step.stats), "wire_bytes": group.wire_stats["bytes_sent"] - sent,
                "digest": _params_digest(params), "pid": os.getpid(), "counts": _counts(),
                "routes": _route_counts(), "sample": samples.pop() if samples else None}
        if i + 1 == steps:
            mine.update(stalls=collective_mod.flight.stall_count(),
                        wire_stats=dict(group.wire_stats),
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0,
                        stall_epoch=stall_epoch)
            if loop_config.get("trace_flight"):
                # The records of this process's user-visible ops, which the
                # driver joins to their collective spans.
                mine["flight"] = [{k: r[k] for k in ("kind", "seq", "channel", "trace_id")}
                                  for r in collective_mod.flight.snapshot(1 << 16)
                                  if r["kind"] in RING_OP_KINDS]
        # Rank 1's record rides the ring to rank 0, whose report the trainer keeps.
        blob = np.frombuffer(pickle.dumps(mine), dtype=np.uint8)
        ranks = [pickle.loads(b.tobytes()) for b in group.allgather(blob, tag="__rec")]
        session_mod.report({"step": i + 1, "loss": mine["loss"], "ranks": ranks})
    require_no_reference("ring worker")


def _ring_run(name: str, config, model_kwargs=None, device: str = "cuda",
              observe: bool = False) -> dict:
    """One TorchTrainer(backend="ring") fit of ring_loop with ``config`` on
    the gang's group, two workers on the one card (``device`` "cpu": on the
    CPU); returns its records by step and rank, its StepStats and its gang
    formation. With ``observe`` the run is traced and rank 1 arms the
    RING_STALL_* latency window; the result then also holds the session's
    spans and rank 1's chaos events."""
    steps = RING_EXACT_STEPS if not config.enabled else RING_QUANT_STEPS
    loop_config = {"steps": steps, "spy": not config.enabled, "device": device}
    if model_kwargs is not None:
        loop_config["config"] = model_kwargs
    stall_log = RING_STORAGE / f"chaos_{name}"
    if observe:
        loop_config.update(trace_flight=True, stall={
            "step": RING_STALL_STEP, "extra_ms": RING_STALL_MS,
            "duration_s": RING_STALL_WINDOW_S, "log_dir": str(stall_log)})
    cuda = device == "cuda"
    trainer = TorchTrainer(
        ring_loop, train_loop_config=loop_config, backend="ring",
        scaling_config=ScalingConfig(num_workers=RING_WORKERS, use_gpu=cuda,
                                     mesh_axes={"dp": RING_WORKERS},
                                     resources_per_worker=(
                                         {"GPU": 1.0 / RING_WORKERS} if cuda else {}),
                                     collective_config=config),
        run_config=RunConfig(name=name, storage_path=str(RING_STORAGE)))
    observed: dict = {}
    # Traced runs start their cluster inside, so that the members inherit
    # the tracing environment; every process of the cluster exports its
    # spans under the cluster's session directory.
    with traced(f"ring_{name}") if observe else contextlib.nullcontext() as own:
        with on_runtime(f"ring_{name}", num_cpus=8) as session:
            t0 = time.perf_counter()
            result = trainer.fit()
            wall = time.perf_counter() - t0
            if observe:
                tracing.flush()
                # read_event_log drops each event's "t" (seconds from the
                # schedule's epoch), which places the window: the raw lines
                # keep it.
                observed = {"spans": tracing.read_spans(session),
                            "chaos_events": read_event_log(str(stall_log)),
                            "chaos_times": [json.loads(line)["t"]
                                            for f in sorted(stall_log.glob("*.jsonl"))
                                            for line in f.read_text().splitlines()
                                            if line.strip()]}
    if own is not None:
        shutil.rmtree(own, ignore_errors=True)
    shutil.rmtree(result.path, ignore_errors=True)
    require(result.error is None, f"ring {name}: {result.error}")
    require([m["step"] for m in result.metrics_history] == list(range(1, steps + 1)),
            f"ring {name}: steps {[m['step'] for m in result.metrics_history]}")
    records = [m["ranks"] for m in result.metrics_history]
    require(all(len(r) == RING_WORKERS for r in records), f"ring {name}: records {records}")
    first = result.attempts[0]
    leases = None
    if cuda:
        # Both members' shares of the card are on the one card.
        leases = require_member_leases(f"ring {name}", result.attempts)
        require(len({v for v, _ in leases}) == 1, f"ring {name}: the members' cards {leases}")
    return {"records": records, "step_stats": result.step_stats, "wall_s": wall,
            "gang_form_s": first["formed"] - first["start"], "steps": steps, "leases": leases,
            **observed}


def _ring_trace_check(run: dict) -> dict:
    """The traced int8 run: every flight record of a user-visible op has
    exactly one collective span of its rank, joined both ways ((comm_seq,
    comm_channel) on the span, the span's trace id on the record), each
    span carries bytes and wire_bytes, and a rank's spans' wire_bytes sum
    to what its ring sent (the last step's record of it is taken before
    that step's own __rec allgather). Rank 1's chaos log holds the latency
    window's events, each inside the window, and rank 0's allreduce of the
    first op rank 1 held back did not end before rank 1 woke."""
    spans = [s for s in run["spans"] if s["name"].startswith("collective.")]
    last = run["records"][-1]
    out: dict = {"spans": len(spans), "by_rank": []}
    ok = True
    for rank, rec in enumerate(last):
        mine = [s for s in spans if s["attributes"]["rank"] == rank]
        index: dict = {}
        for s in mine:
            key = (s["attributes"].get("comm_channel"), s["attributes"].get("comm_seq"))
            index.setdefault(key, []).append(s)
        joined = [index.get((r["channel"], r["seq"]), []) for r in rec["flight"]]
        one_each = all(len(j) == 1 for j in joined)
        same_trace = all(len(j) == 1 and j[0]["trace_id"] == r["trace_id"]
                         for j, r in zip(joined, rec["flight"]))
        attrs_present = all("bytes" in s["attributes"] and "wire_bytes" in s["attributes"]
                            for s in mine)
        recs = [s for s in mine if s["attributes"]["comm_channel"].endswith(":allgather:__rec")]
        final_rec = max(recs, key=lambda s: s["attributes"]["comm_seq"])
        wire_sum = sum(s["attributes"]["wire_bytes"] for s in mine)
        wire_ok = wire_sum - final_rec["attributes"]["wire_bytes"] == \
            rec["wire_stats"]["bytes_sent"]
        out["by_rank"].append({"records": len(rec["flight"]), "op_spans": len(mine),
                               "one_span_each": one_each, "same_trace": same_trace,
                               "bytes_and_wire_bytes": attrs_present, "wire_bytes": wire_sum,
                               "ring_bytes_sent": rec["wire_stats"]["bytes_sent"],
                               "wire_sum_ok": wire_ok})
        ok &= one_each and same_trace and attrs_present and wire_ok and bool(rec["flight"])
    # The latency window: one event in rank 1's log; the op it held back.
    events = [e for e in run["chaos_events"] if e["point"] == "latency_point"]
    epoch = last[1]["stall_epoch"]
    window: dict = {"events": events, "extra_ms": RING_STALL_MS}
    times = run["chaos_times"]
    if len(events) >= 1 and len(times) == len(events) and epoch is not None:
        # The event's t is seconds from the epoch, rounded to 0.1 ms.
        sleep_start_ns = int((epoch + min(times)) * 1e9)
        woke_ns = sleep_start_ns + int(RING_STALL_MS * 1e6)
        slack_ns = 200_000
        held = min((s for s in spans if s["attributes"]["rank"] == 1
                    and s["name"] == "collective.allreduce"
                    and s["start_ns"] >= woke_ns - slack_ns), key=lambda s: s["start_ns"],
                   default=None)
        peer = next((s for s in spans if held is not None and s["attributes"]["rank"] == 0
                     and s["attributes"]["comm_channel"] == held["attributes"]["comm_channel"]
                     and s["attributes"]["comm_seq"] == held["attributes"]["comm_seq"]), None)
        if peer is not None:
            window.update(
                rank0_span_ms=(peer["end_ns"] - peer["start_ns"]) / 1e6,
                rank0_entered_after_ms=(peer["start_ns"] - sleep_start_ns) / 1e6,
                rank0_waited_ms=(peer["end_ns"] - max(peer["start_ns"], sleep_start_ns)) / 1e6,
                comm_seq=held["attributes"]["comm_seq"])
        window["ok"] = bool(peer is not None and peer["end_ns"] >= woke_ns - slack_ns
                            and window["rank0_waited_ms"] >= RING_STALL_MS - slack_ns / 1e6)
    else:
        window["ok"] = False
    # Each allreduce rank 1 entered inside the window (the overlap runs a
    # few at once) waited; none outside it.
    window["events_in_window"] = bool(times) and all(0.0 <= t < RING_STALL_WINDOW_S
                                                     for t in times)
    out["latency_window"] = window
    out["ok"] = bool(ok and window["ok"] and window["events_in_window"])
    return out


def _ring_summary(name: str, run: dict, config: TransformerConfig) -> dict:
    """The numbers phase 29 prints for one run, and its checks: the ranks'
    parameters equal bitwise after every step, no stall, and each member's
    launches what its steps imply."""
    records, steps = run["records"], run["steps"]
    for i, ranks in enumerate(records):
        require(ranks[0]["digest"] == ranks[1]["digest"],
                f"ring {name}: the ranks' parameters differ after step {i + 1}: "
                f"{[r['digest'] for r in ranks]}")
    last = records[-1]
    stalls = [r["stalls"] for r in last]
    require(stalls == [0] * RING_WORKERS, f"ring {name}: stalls {stalls} under uniform load")
    want = _expected(config.n_layers, kernel_forwards=steps, kernel_backwards=steps)
    for rank, rec in enumerate(last):
        _path(f"ring_{name}[rank{rank}]", want, rec["counts"], rec["routes"], "wgmma",
              steps=steps)
    timed = records[1:]  # step 1 builds the buckets and warms the allocator
    step_s = [max(r["step_s"] for r in ranks) for ranks in timed]
    tokens = RING_WORKERS * RING_BATCH * config.max_seq
    collective_s, exposed_s = [], []
    for rank_records in run["step_stats"].values():
        collective_s += [r.get("collective_s", 0.0) for r in rank_records[1:]]
        exposed_s += [r.get("comm_exposed_s", 0.0) for r in rank_records[1:]]
    return dict(
        steps=steps, losses=[ranks[0]["loss"] for ranks in records],
        step_ms=1e3 * statistics.median(step_s),
        tokens_per_s=tokens / statistics.median(step_s),
        grad_sync_s=statistics.median(max(r["split"]["grad_sync_s"] for r in ranks)
                                      for ranks in timed),
        split={k: statistics.median(ranks[0]["split"][k] for ranks in timed)
               for k in timed[0][0]["split"]},
        collective_s=statistics.median(collective_s), comm_exposed_s=statistics.median(exposed_s),
        wire_bytes_per_step=statistics.median(ranks[0]["wire_bytes"] for ranks in timed),
        wire_stats=[r["wire_stats"] for r in last], peak_gib=[r["peak_gib"] for r in last],
        gang_form_s=run["gang_form_s"], wall_s=run["wall_s"], stalls=stalls,
        counts={k: sum(r["counts"][k] for r in last) for k in last[0]["counts"]},
        routes={k: {rt: sum(r["routes"][k][rt] for r in last) for rt in ("wgmma", "mma_sync")}
                for k in last[0]["routes"]})


def _ring_exact_check(run: dict) -> dict:
    """Each rank's synced gradient against ((g0.double() + g1.double())
    .float()) / 2 from both ranks' unsynced gradients, bitwise at the
    seeded indices, every step."""
    mismatches = []
    for i, ranks in enumerate(run["records"]):
        g0, g1 = (torch.from_numpy(r["sample"][0]) for r in ranks)
        want = (g0.double() + g1.double()).float() / 2
        for rank, r in enumerate(ranks):
            got = torch.from_numpy(r["sample"][1])
            mismatches.append(int((got.view(torch.int32) != want.view(torch.int32)).sum()))
    require(not any(mismatches),
            f"ring exact: synced gradients differ from the f64 sum at {mismatches} indices")
    return {"indices": RING_SAMPLE, "mismatches": mismatches}


def _codec_ms(fn, reps: int = 5) -> float:
    """Median device milliseconds of fn() by CUDA events."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bits_equal(a, b) -> bool:
    a = torch.as_tensor(a).contiguous().reshape(-1).cpu()
    b = torch.as_tensor(b).contiguous().reshape(-1).cpu()
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.shape == b.shape and torch.equal(a.view(width), b.view(width))


def _ring_codec() -> dict:
    """(a): the block-scaled codec on the card, on a seeded flat gradient of
    the ring config's size, int8 and fp8 at block 256: its encode and
    decode times, the encode's bytes bound, and q, the scales and the
    decoded values held bitwise against the numpy plain version on a
    block-aligned slice of RING_CODEC_SLICE elements, with the
    error-feedback residual after two encodes."""
    config = TransformerConfig(**{**SHARDED_CONFIG, "n_layers": RING_LAYERS})
    n = num_params(init_params(config, seed=SEED, device="meta"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2901)
    flat = torch.randn(n, generator=gen, device="cuda")
    flat.mul_(torch.randn(n, generator=gen, device="cuda").mul_(2.0).exp_())
    rng = np.random.default_rng(SEED + 2902)
    starts = [int(s) * RING_BLOCK for s in rng.integers(0, (n - RING_CODEC_SLICE) // RING_BLOCK, 2)]
    out = {"elements": n, "slice": RING_CODEC_SLICE, "block": RING_BLOCK}
    for kind in ("int8", "fp8"):
        cfg = quant_mod.CollectiveConfig(quantize=kind, block_size=RING_BLOCK)
        enc = quant_mod.encode_device(flat, cfg)
        encode_ms = _codec_ms(lambda: quant_mod.encode_device(flat, cfg))
        decode_ms = _codec_ms(lambda: quant_mod.decode_device(enc, flat.device))
        nbytes = 4 * n + enc[1].numel() + 4 * enc[2].numel()
        s0, s1 = starts
        x = flat[s0:s0 + RING_CODEC_SLICE].cpu().numpy()
        t0 = time.perf_counter()
        plain = quant_mod.encode_plain(x, cfg)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain_dec = quant_mod.decode_plain(plain)
        plain_decode_s = time.perf_counter() - t0
        blocks = slice(s0 // RING_BLOCK, (s0 + RING_CODEC_SLICE) // RING_BLOCK)
        decoded = quant_mod.decode_device(enc, flat.device)[s0:s0 + RING_CODEC_SLICE]
        checks = {"q": _bits_equal(enc[1][s0:s0 + RING_CODEC_SLICE], plain[1]),
                  "scales": _bits_equal(enc[2][blocks], plain[2]),
                  "decoded": _bits_equal(decoded, plain_dec)}
        # Error feedback: two encodes from the same site, on the card and
        # in numpy; the second encoding and the residual after it.
        x2 = flat[s1:s1 + RING_CODEC_SLICE]
        ef_dev, ef_np = quant_mod.ErrorFeedback(), quant_mod.ErrorFeedback()
        for part in (flat[s0:s0 + RING_CODEC_SLICE], x2):
            got = quant_mod.to_host(ef_dev.encode_device(("rs", "__ar", 0), part, cfg))
            want = ef_np.encode(("rs", "__ar", 0), part.cpu().numpy(), cfg)
        checks["ef_q"] = _bits_equal(got[1], want[1]) and _bits_equal(got[2], want[2])
        checks["ef_residual"] = _bits_equal(ef_dev.residual(("rs", "__ar", 0)),
                                            ef_np.residual(("rs", "__ar", 0)))
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        out[kind] = dict(encode_ms=encode_ms, decode_ms=decode_ms, bound_ms=bound_ms,
                         bound_share=bound_ms / encode_ms, encode_bytes=nbytes,
                         plain_encode_s=plain_s, plain_decode_s=plain_decode_s,
                         plain_elements=RING_CODEC_SLICE, wire_kind=enc[0], bitwise=checks)
        del enc, decoded
        require(all(checks.values()), f"ring codec {kind}: not the plain version's bits: {checks}")
    del flat
    torch.cuda.empty_cache()
    return out


def ring_overlap_worker(ctx, steps: int, overlap: bool, bucket_bytes: int) -> dict:
    """bench.py's _overlap_worker on the port: the paired gradient-sync
    microbench on its synthetic tree (leaves in its flattened order, CPU
    tensors), then its 2-rank data-parallel SGD whose loss trajectory must
    be identical between the modes."""
    group_name = ctx.group_name
    coll = ctx.collective()
    rng = np.random.default_rng(100 + ctx.rank)
    tree = {"emb": rng.standard_normal((1024, 512)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((512, 512)).astype(np.float32),
                        "b": rng.standard_normal(512).astype(np.float32)} for _ in range(10)],
            "head": rng.standard_normal((512, 1024)).astype(np.float32),
            "scale": np.float32(0.5)}
    # jax.tree.leaves' order: sorted keys, list items in order.
    leaves = ([tree["emb"], tree["head"]] + [x for layer in tree["layers"]
                                             for x in (layer["b"], layer["w"])] + [tree["scale"]])
    grads = [torch.from_numpy(np.array(x)) for x in leaves]
    nbytes = sum(4 * bucketing_mod.leaf_size(x) for x in grads)
    n_buckets = len(bucketing_mod.partition_buckets(grads, bucket_bytes))
    torch_utils.sync_gradients_sharded(grads, group_name, overlap=False)
    coll.barrier()
    t0 = time.perf_counter()
    torch_utils.sync_gradients_sharded(grads, group_name, overlap=False)
    comm_ref = time.perf_counter() - t0
    coll.barrier()
    spin = rng.standard_normal((384, 384)).astype(np.float32)
    wall = exposed = collective = float("inf")
    for _ in range(steps):
        t0 = time.perf_counter()
        if overlap:
            handle = torch_utils.begin_gradient_sync(grads, group_name,
                                                     bucket_bytes=bucket_bytes)
            acc = spin  # the rest of a backward: BLAS releases the GIL
            while time.perf_counter() - t0 < 1.5 * comm_ref:
                acc = (acc @ spin) / 384.0
            handle.result()
            step_exposed = handle.stats["comm_exposed_s"]
            step_collective = handle.stats["collective_s"]
        else:
            torch_utils.sync_gradients_sharded(grads, group_name, overlap=False)
            step_exposed = step_collective = time.perf_counter() - t0
        wall = min(wall, time.perf_counter() - t0)
        exposed = min(exposed, step_exposed)
        collective = min(collective, step_collective)
        coll.barrier()
    prng = np.random.default_rng(7)
    true_w = prng.standard_normal(24).astype(np.float32)
    x = prng.standard_normal((96, 24)).astype(np.float32)
    y = x @ true_w
    xs, ys = x[ctx.rank::ctx.world_size], y[ctx.rank::ctx.world_size]
    w = {"a": np.zeros(16, np.float32), "b": np.zeros(8, np.float32)}
    traj = []
    for _ in range(12):
        w_full = np.concatenate([w["a"], w["b"]])
        err = xs @ w_full - ys
        g_full = ((2.0 / len(xs)) * (xs.T @ err)).astype(np.float32)
        g = [torch.from_numpy(g_full[:16].copy()), torch.from_numpy(g_full[16:].copy())]
        if overlap:
            g = torch_utils.begin_gradient_sync(g, group_name, bucket_bytes=48).result()
        else:
            g = torch_utils.sync_gradients_sharded(g, group_name, overlap=False)
        w = {"a": w["a"] - 0.2 * g[0].numpy(), "b": w["b"] - 0.2 * g[1].numpy()}
        traj.append(float(np.mean((x @ np.concatenate([w["a"], w["b"]]) - y) ** 2)))
    return {"wall_s": wall, "comm_exposed_s": exposed, "collective_s": collective,
            "comm_ref_s": comm_ref, "grad_bytes": int(nbytes), "buckets": n_buckets,
            "loss_trajectory": traj}


def _ring_overlap_bench() -> dict:
    """(c): bench.py --overlap off and on, on one 2-member CPU ring gang."""
    gang = WorkerGang(RING_WORKERS, use_gpu=False, backend="ring")
    try:
        out = {}
        for mode in ("off", "on"):
            per_rank = gang.run(ring_overlap_worker, timeout=600, steps=OVERLAP_STEPS,
                                overlap=mode == "on", bucket_bytes=OVERLAP_BUCKET_BYTES)
            slow = max(per_rank, key=lambda r: r["comm_exposed_s"])
            hidden = (max(0.0, 1.0 - slow["comm_exposed_s"] / slow["collective_s"])
                      if slow["collective_s"] > 0 else 0.0)
            out[mode] = dict(slow, hidden=hidden,
                             bytes_per_s=slow["grad_bytes"] / slow["wall_s"])
    finally:
        gang.shutdown()
    require(out["on"]["loss_trajectory"] == out["off"]["loss_trajectory"],
            f"ring overlap: trajectories differ: {out['on']['loss_trajectory']} against "
            f"{out['off']['loss_trajectory']}")
    return out


def phase_ring() -> dict:
    """Phase 29: the host-side collectives. (a) the codec on the card; (b)
    TorchTrainer(backend="ring") at bench.py's sharded config, two members
    sharing the one card, on the exact wire (its synced gradients held to
    the f64 sum bitwise), then int8 and fp8 with overlap (parameters equal
    across the ranks, the loss within RING_LOSS_REL_TOL of the exact run's
    and falling, the wire at most RING_WIRE_RATIO of the exact one); (c)
    bench.py's overlap microbench on two CPU ring members. Returns the
    numbers and the members' launch counts and routes, summed."""
    started = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    codec = _ring_codec()
    log("ring_codec", **codec)
    config = TransformerConfig(**{**SHARDED_CONFIG, "n_layers": RING_LAYERS})
    runs, summaries = {}, {}
    if RING_STORAGE.exists():
        shutil.rmtree(RING_STORAGE)
    RING_STORAGE.mkdir(parents=True)
    try:
        for name, cfg in (("exact", quant_mod.CollectiveConfig()),
                          ("int8", quant_mod.CollectiveConfig(quantize="int8", overlap=True)),
                          ("fp8", quant_mod.CollectiveConfig(quantize="fp8", overlap=True))):
            runs[name] = _ring_run(name, cfg, observe=name == "int8")
            summaries[name] = _ring_summary(name, runs[name], config)
            log("ring_train", run=name, quantize=cfg.quantize, overlap=cfg.overlap,
                **summaries[name])
            if name == "int8":
                trace_check = _ring_trace_check(runs[name])
                trace_check["span_counts"] = _span_counts(runs[name].pop("spans"))
                OBSERVABILITY["ring"] = trace_check
                log("ring_trace", **trace_check)
                require(trace_check["ok"], f"ring int8: traced run {trace_check}")
    finally:
        shutil.rmtree(RING_STORAGE, ignore_errors=True)
    exact_check = _ring_exact_check(runs["exact"])
    exact = summaries["exact"]
    for name in ("int8", "fp8"):
        s = summaries[name]
        close = [abs(a - b) / abs(b) for a, b in zip(s["losses"], exact["losses"])]
        s["loss_rel_diff"] = close
        s["wire_ratio"] = s["wire_bytes_per_step"] / exact["wire_bytes_per_step"]
        require(s["losses"][0] == exact["losses"][0],
                f"ring {name}: step 1's loss {s['losses'][0]} is not the exact run's "
                f"{exact['losses'][0]} (same parameters and batch)")
        require(max(close) <= RING_LOSS_REL_TOL,
                f"ring {name}: losses {s['losses'][:3]} against the exact wire's "
                f"{exact['losses']}: relative {close}")
        require(s["losses"][-1] < s["losses"][0], f"ring {name}: loss did not fall: "
                                                  f"{s['losses']}")
        require(s["wire_ratio"] <= RING_WIRE_RATIO,
                f"ring {name}: {s['wire_bytes_per_step']} wire bytes a step, the exact "
                f"wire's {exact['wire_bytes_per_step']}")
    with on_runtime("ring_overlap", num_cpus=8):
        bench = _ring_overlap_bench()
    log("ring_overlap", **bench)
    counts = {k: sum(s["counts"][k] for s in summaries.values()) for k in exact["counts"]}
    routes = {k: {rt: sum(s["routes"][k][rt] for s in summaries.values())
                  for rt in ("wgmma", "mma_sync")} for k in exact["routes"]}
    steps = sum(s["steps"] for s in summaries.values()) * RING_WORKERS
    result = dict(codec=codec, exact_check=exact_check, runs=summaries, overlap_bench=bench,
                  counts=counts, routes=routes, kernel_forwards=steps, kernel_backwards=steps,
                  seconds=time.perf_counter() - started)
    log("ring", exact_check=exact_check, seconds=result["seconds"],
        wire_ratio={k: summaries[k]["wire_ratio"] for k in ("int8", "fp8")},
        loss_rel_diff={k: summaries[k]["loss_rel_diff"] for k in ("int8", "fp8")})
    return result


# ---------------------------------------------------------------- phase 30: serve-LLM
# The serve-LLM engine (ray_tpu_torch.serve.llm): release/benchmarks_serve_llm.py's
# three phases on the card's host, its deployment uncut (1 prefill replica on
# the host, 2 decode replicas at max_slots 128 with buckets 32/64/128, the
# default KV geometry and the int8 wire, hedging, health checks every 1 s,
# two proxies). The decode replicas take a quarter of the card each, so that
# phase 3's second app fits beside them: their KV pools and the wire's
# decode live on the card. The load is the bench's full load (8 handle
# threads, 2 HTTP clients) in 4 s windows (the bench's are 10 s).
# sequences/s is over the baseline's wall, which may run past its 4 s.
LLM_BATCH, LLM_MAX_TOKENS = 64, 4      # the bench's BATCH and MAX_TOKENS
LLM_HANDLE_THREADS, LLM_HTTP_THREADS = 8, 2
LLM_SECONDS = 4.0
# The steady-state probe's own limit (the bench's is 30 s). Phase 1's load
# runs on past its window until the probe returns: a window counts only
# once it reached its 100 iterations, and the engine iterates only under
# load, so a slower host lengthens phase 1 instead of failing it.
LLM_PROBE_TIMEOUT_S = 20.0
LLM_KILL_REPLICA_S, LLM_KILL_PROXY_S = 1.0, 2.0
LLM_RECOVER_S = 90.0
LLM_SCALE_WAIT_S = 90.0
LLM_GPU_SHARE = 0.25
LLM_PROMPT = "warm cache line"
# The reference's release gate for its full load (release_tests.yaml):
# printed beside the port's sequences/s as a finding, not held here.
LLM_RELEASE_GATE_QPS = 3800
# The card's decode of a quantized KV payload against the plain numpy
# decode: the ToyLM's KV of these prompts and a seeded normal block.
LLM_CODEC_PROMPTS = ("warm cache line", " ".join(f"w{i}" for i in range(12)), "hello tpu")
LLM_CODEC_TOKENS = 4096
# Phase 30 runs traced with every sequence sampled. One request, sent with
# an X-RayTPU-Trace header before the load, must keep the header's trace id
# from the proxy to its last decode iteration.
LLM_TRACE_ID, LLM_TRACE_PARENT, LLM_TRACE_REQUEST = "beef" * 8, "cafe" * 4, "chip-trace-1"
# release/benchmarks_serve_llm_observability.py's phase 1 at its full size:
# 24 paired OFF/ON decode windows (ABBA) of 16 sequences of 64 tokens, the
# decode step sized by decode_flops, the KV pool on the card. The bench
# gates overhead_pct at 2%; here it is held to 10% and recorded. The card
# machine's process clock advances in ticks of about 10 ms (measured and
# printed as process_clock_tick_ms), coarse beside a window's 30 ms of
# CPU: the denominator is the OFF windows' CPU summed over their
# iterations, and the micro-measures take 100,000 spans and 20,000 records.
LLM_OBS_WINDOWS, LLM_OBS_SEQS, LLM_OBS_TOKENS = 24, 16, 64
LLM_OBS_SPAN_REPS, LLM_OBS_RECORD_REPS = 100_000, 20_000
LLM_OBS_GATE_PCT, LLM_OBS_HOLD_PCT = 2.0, 10.0


def llm_expected_tokens(prompt: str, n: int, model_id: str = "") -> list:
    """The toy LM's tokens, as release/benchmarks_serve_llm.py's
    _expected_tokens computes them."""
    toks = llm_dep.tokenize(prompt)
    return [llm_dep._digest(model_id, tuple(toks), i) % 32000 for i in range(n)]


def _llm_codec_on_card(device: str) -> dict:
    """int8 and fp8 KV payloads decoded on the card (decode_device, pinned
    copies of q and the scales) and paged into a KVBlockPool there, held
    bitwise against quantization.decode_plain on the host."""
    cfg = llm.LLMConfig()
    rng = np.random.default_rng(SEED)
    kvs = [llm_dep.ToyLM(cfg).prefill(llm_dep.tokenize(p)) for p in LLM_CODEC_PROMPTS]
    kvs.append(rng.standard_normal((LLM_CODEC_TOKENS, cfg.kv_dim)).astype(np.float32))
    out = {}
    for quantize in ("int8", "fp8"):
        wire_cfg = llm.LLMConfig(kv_wire_quantize=quantize).wire_config()
        pool = llm.KVBlockPool(cfg.num_kv_blocks, cfg.block_tokens, cfg.kv_dim, device=device)
        worst, equal, nbytes = 0.0, True, 0
        for kv in kvs:
            payload = llm.encode_kv_blocks(kv, wire_cfg)
            nbytes += quant_mod.wire_nbytes(payload[2])
            plain = quant_mod.decode_plain(payload[2]).reshape(kv.shape)
            ids = pool.alloc(pool.blocks_needed(kv.shape[0]))
            pool.write(ids, llm.decode_kv_blocks(payload, device))
            pages = pool.read(ids).cpu().numpy().reshape(-1)[:plain.size].reshape(plain.shape)
            equal &= pages.tobytes() == plain.tobytes()
            worst = max(worst, float(np.abs(pages - plain).max()))
            pool.release(ids)
        out[quantize] = {"bitwise": bool(equal), "max_abs_diff": worst, "wire_bytes": nbytes,
                         "f32_bytes": sum(kv.nbytes for kv in kvs),
                         "pool_device": str(pool.device)}
    return out


def _llm_obs_overhead(device: str = "cuda") -> dict:
    """The observability bench's phase 1 in this process: ABBA-ordered OFF
    windows (tracing off, no sequence sampled) and ON windows (tracing on,
    every sequence sampled: decode.iter spans, trace ids on token events,
    timeline records), each timing submit to drain on the process clock.
    overhead_pct is the bench's composed ratio: the micro-measured CPU of
    what the sampled path adds an iteration (one decode.iter span, and the
    terminal records amortized over the iterations) over the OFF windows'
    CPU an iteration (their sum over their iterations, not the bench's
    median window: the process clock's ticks are coarse here)."""
    from ray_tpu_torch.serve._common import Deadline

    cfg = llm.LLMConfig(max_slots=LLM_OBS_SEQS, slot_buckets=(LLM_OBS_SEQS,),
                        num_kv_blocks=1024, decode_flops=4_000_000)
    gcfg = config_mod.global_config()
    was = gcfg.tracing_enabled
    trace_ctx = {"trace_id": "ab" * 16, "span_id": "cd" * 8}
    model = llm_dep.ToyLM(cfg, device=device)

    def build(sampled: bool, n: int = LLM_OBS_SEQS) -> list:
        seqs = []
        for i in range(n):
            toks = llm_dep.tokenize(f"bench seq {i}")
            s = llm.SequenceState(request_id=f"obs-{time.monotonic_ns()}-{i}",
                                  prompt_tokens=toks, max_tokens=LLM_OBS_TOKENS,
                                  kv_data=model.prefill(toks, ""), deadline=Deadline.never())
            s.sampled, s.trace_ctx = sampled, (dict(trace_ctx) if sampled else None)
            seqs.append(s)
        return seqs

    async def window(on: bool) -> tuple:
        gcfg.tracing_enabled = on
        eng = llm.DecodeEngine(cfg, model, deployment="bench", replica_id="r0", device=device)
        seqs = build(on)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        for s in seqs:
            await eng.submit(s)
        await asyncio.gather(*(s.future for s in seqs))
        torch.cuda.synchronize()
        cpu, wall = time.process_time() - c0, time.perf_counter() - t0
        eng.stop()
        require(eng.ledger.in_flight() == 0, "serve_llm obs: tokens left in flight")
        return wall, cpu

    async def run_all() -> tuple:
        await window(False)  # settle both paths, untimed
        await window(True)
        off, on = [], []
        for i in range(LLM_OBS_WINDOWS):
            first_on = bool(i % 2)
            for mode in (first_on, not first_on):
                (on if mode else off).append(await window(mode))
        return off, on

    try:
        off, on = asyncio.run(run_all())
        gcfg.tracing_enabled = True
        reps = LLM_OBS_SPAN_REPS
        c0 = time.process_time()
        for _ in range(reps):
            tracing.finish(tracing.begin("decode.iter", parent=trace_ctx, replica="r0",
                                         slots=LLM_OBS_SEQS, bucket=LLM_OBS_SEQS))
        span_us = (time.process_time() - c0) / reps * 1e6
        donor = build(True, 1)[0]
        donor.generated = list(range(LLM_OBS_TOKENS))
        base = time.monotonic()
        donor.enqueued_at, donor.slot_admitted_at = base, base + 0.001
        donor.first_token_at = base + 0.01
        donor.token_times = [base + 0.01 * (i + 1) for i in range(LLM_OBS_TOKENS)]
        donor.prefill_s, donor.kv_transfer_s = 0.005, 0.001
        reps = LLM_OBS_RECORD_REPS
        c0 = time.process_time()
        for _ in range(reps):
            llm_obs.record(llm_obs.seq_record(donor, outcome="productive", cause="completed",
                                              split={"replay_discarded": 0}, deployment="bench",
                                              replica_id="r0", fence="f0"))
        record_us = (time.process_time() - c0) / reps * 1e6
    finally:
        gcfg.tracing_enabled = was
    llm_obs.flush()
    tick_start = time.process_time()
    while (tick := time.process_time() - tick_start) == 0.0:
        pass
    tokens = LLM_OBS_SEQS * LLM_OBS_TOKENS
    off_iter_us = sum(c for _, c in off) / (len(off) * LLM_OBS_TOKENS) * 1e6
    obs_us = span_us + LLM_OBS_SEQS / LLM_OBS_TOKENS * record_us
    return {
        "tokens_per_s_off": tokens / statistics.median(w for w, _ in off),
        "tokens_per_s_on": tokens / statistics.median(w for w, _ in on),
        "span_us": span_us, "seq_record_us": record_us, "off_iter_cpu_us": off_iter_us,
        "overhead_pct": 100.0 * obs_us / off_iter_us,
        "paired_delta_pct": statistics.median(100.0 * (c_on - c_off) / c_off
                                              for (_, c_off), (_, c_on) in zip(off, on)),
        "windows": LLM_OBS_WINDOWS, "gate_pct": LLM_OBS_GATE_PCT, "held_to_pct": LLM_OBS_HOLD_PCT,
        "kv_device": device, "process_clock_tick_ms": tick * 1e3,
        "off_window_cpu_ms": [1e3 * c for _, c in off],
    }


def _llm_wire_trace(parent: dict, device: str = "cuda") -> dict:
    """The KV device wire between two ring ranks (threads of this process)
    under the sampled request's context: the int8 payload of the toy model's
    KV crosses with its channel.push span's context, is popped and decoded
    on the card, bitwise the plain decode, and the pop's span and last_trace
    join the request's trace."""
    import torch.distributed as dist

    store = dist.HashStore()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        groups = list(pool.map(lambda r: collective_mod.RingGroup(2, r, "llm_kv_wire",
                                                                  store=store), range(2)))
        try:
            cfg = llm.LLMConfig()
            kv = llm_dep.ToyLM(cfg).prefill(llm_dep.tokenize(LLM_PROMPT))
            tx = llm.KVDeviceWire(groups[0], peer=1, device="cpu", wire_cfg=cfg.wire_config())
            rx = llm.KVDeviceWire(groups[1], peer=0, device=device)
            pushed = pool.submit(tx.push, 0, kv, parent)
            got = rx.pop(0, timeout=60).cpu().numpy()
            pushed.result(timeout=60)
        finally:
            for g in groups:
                g.destroy()
    plain = quant_mod.decode_plain(llm.encode_kv_blocks(kv, cfg.wire_config())[2])
    return {"last_trace": rx.last_trace,
            "bitwise": got.tobytes() == plain.reshape(kv.shape).tobytes()}


def _llm_trace_check(session: str, decode_pids: list, prefill_pids: list, wire: dict,
                     proxy_pid: int) -> dict:
    """The sampled request's trace, joined across the first proxy (its
    actor's process), a decode replica, the prefill replica and the KV
    wire; decode.iter spans
    from every decode replica; the request's timeline record and its
    Perfetto view."""
    want = {"serve.request", "serve.replica", "serve.prefill", "serve.kv_transfer",
            "decode.iter", "channel.push", "channel.pop"}

    def ready(spans):
        mine = {s["name"].split(" ")[0] for s in spans if s["trace_id"] == LLM_TRACE_ID}
        iters = {s["pid"] for s in spans if s["name"] == "decode.iter"}
        return want <= mine and set(decode_pids) <= iters

    spans = _spans_when(session, ready)
    mine = [s for s in spans if s["trace_id"] == LLM_TRACE_ID]
    by_name: dict = {}
    for s in mine:
        by_name.setdefault(s["name"], []).append(s)
    req = by_name.get("serve.request /llm", [{}])[0]
    decode_rep = by_name.get("serve.replica llm_llm_decode", [{}])[0]
    prefill_rep = by_name.get("serve.replica llm_llm_prefill", [{}])[0]
    prefill = by_name.get("serve.prefill", [{}])[0]
    kv = by_name.get("serve.kv_transfer", [{}])[0]
    iters = by_name.get("decode.iter", [])
    push = by_name.get("channel.push", [{}])[0]
    pop = by_name.get("channel.pop", [{}])[0]
    chain = {
        "request_under_header": req.get("parent_id") == LLM_TRACE_PARENT
        and req.get("pid") == proxy_pid,
        "decode_replica_under_request": decode_rep.get("parent_id") == req.get("span_id")
        and decode_rep.get("pid") in decode_pids,
        "prefill_under_decode_replica": prefill.get("parent_id") == decode_rep.get("span_id"),
        "prefill_replica_under_prefill": prefill_rep.get("parent_id") == prefill.get("span_id")
        and prefill_rep.get("pid") in prefill_pids,
        "kv_transfer_under_decode_replica": kv.get("parent_id") == decode_rep.get("span_id"),
        "wire_push_under_kv_transfer": push.get("parent_id") == kv.get("span_id"),
        "wire_pop_under_push": pop.get("parent_id") == push.get("span_id")
        and (wire["last_trace"] or {}).get("span_id") == push.get("span_id"),
        "decode_iters": len(iters) == LLM_MAX_TOKENS
        and all(s["parent_id"] == decode_rep.get("span_id") for s in iters),
        "wire_bitwise": wire["bitwise"],
    }
    iter_pids = sorted({s["pid"] for s in spans if s["name"] == "decode.iter"})
    record = next((r for r in llm_obs.read_sequences(session)
                   if r.get("kind") == "seq" and r.get("request_id") == LLM_TRACE_REQUEST), None)
    view_path = Path(session) / f"{LLM_TRACE_REQUEST}.perfetto.json"
    with open(view_path, "w") as f:
        json.dump(timeline_mod.build_sequence_trace(session, LLM_TRACE_REQUEST), f)
    with open(view_path) as f:
        view = json.load(f)
    tokens = [e for e in view["traceEvents"] if e.get("cat") == "token"]
    out = {"chain": chain, "decode_iter_pids": iter_pids, "decode_pids": sorted(decode_pids),
           "record_trace_id": (record or {}).get("trace_id"),
           "view_events": len(view["traceEvents"]), "view_tokens": len(tokens),
           "view_bytes": view_path.stat().st_size, "spans": _span_counts(spans)}
    out["ok"] = bool(all(chain.values()) and set(decode_pids) <= set(iter_pids)
                     and out["record_trace_id"] == LLM_TRACE_ID
                     and len(tokens) == LLM_MAX_TOKENS)
    return out


def _llm_load(seconds: float, handle_threads: int, http_threads: int, ports: list,
              probe_box: dict | None = None, during=None) -> dict:
    """release/benchmarks_serve_llm.py's _run_load: handle threads sending
    generate_batch waves of LLM_BATCH prompts, HTTP clients sending one
    sequence a request to the proxies (failing over on a connection error,
    honouring 503 Retry-After), the steady-state probe once mid-load if
    `probe_box` is given (the load then runs on until the probe returns),
    and `during()` from the calling thread. Every completed sequence's
    tokens are held to the digest; a wrong one counts as lost."""
    import http.client

    stats = {"http_latencies": [], "batch_latencies": [], "completed": 0, "shed": 0,
             "lost": 0, "lost_detail": [], "failovers": 0, "attempts_shed": 0, "shed_moves": 0}
    lock = threading.Lock()
    deadline = time.perf_counter() + seconds
    expect = llm_expected_tokens(LLM_PROMPT, LLM_MAX_TOKENS)
    probe_open = threading.Event()
    if probe_box is not None:
        probe_open.set()

    def loading() -> bool:
        return time.perf_counter() < deadline or probe_open.is_set()

    def handle_worker(i: int) -> None:
        handle = serve.get_deployment_handle("llm_decode", "llm").options(
            method_name="generate_batch")
        body = {"prompts": [LLM_PROMPT] * LLM_BATCH, "max_tokens": LLM_MAX_TOKENS}
        while loading():
            t0 = time.perf_counter()
            try:
                results = handle.remote(body).result(timeout=90)["results"]
            except Exception as exc:  # a failed wave is lost, with its cause
                with lock:
                    stats["lost"] += LLM_BATCH
                    stats["lost_detail"].append(f"batch failed: {type(exc).__name__}: "
                                                f"{str(exc)[:160]}")
                continue
            bad = [r for r in results if r["tokens"] != expect]
            with lock:
                stats["batch_latencies"].append(time.perf_counter() - t0)
                stats["completed"] += len(results) - len(bad)
                stats["lost"] += len(bad)
                if bad:
                    stats["lost_detail"].append(f"wrong tokens: {bad[0]['tokens']!r}")
        # Waves a replica shed, and those moved to the other replica.
        reliability = handle._get_router().reliability()
        with lock:
            for key in ("attempts_shed", "shed_moves"):
                stats[key] += reliability.get(key, 0)

    def http_worker(i: int) -> None:
        order = ports[i % len(ports):] + ports[:i % len(ports)]
        conns = {p: http.client.HTTPConnection("127.0.0.1", p, timeout=15) for p in order}
        n = 0
        while loading():
            body = json.dumps({"prompt": LLM_PROMPT, "max_tokens": LLM_MAX_TOKENS,
                               "request_id": f"http-{i}-{n}"})
            n += 1
            start, outcome = time.perf_counter(), None
            while outcome is None and time.perf_counter() < deadline + 30:
                for port in order:
                    try:
                        conns[port].request("POST", "/llm", body=body,
                                            headers={"Content-Type": "application/json"})
                        resp = conns[port].getresponse()
                        data = resp.read()
                    except (OSError, http.client.HTTPException):
                        conns[port].close()
                        conns[port] = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
                        with lock:
                            stats["failovers"] += 1
                        continue
                    if resp.status == 200:
                        tokens = json.loads(data)["tokens"]
                        outcome = ("ok",) if tokens == expect else (
                            "lost", f"http wrong tokens: {tokens!r}")
                        break
                    if resp.status == 503:
                        with lock:
                            stats["shed"] += 1
                        time.sleep(float(resp.getheader("Retry-After", "0.2")))
                        continue
                    outcome = ("lost", f"HTTP {resp.status}: {data[:120]!r}")
                    break
                else:
                    time.sleep(0.1)
            outcome = outcome or ("lost", "no 2xx before the window's end and 30 s")
            with lock:
                if outcome[0] == "ok":
                    stats["http_latencies"].append(time.perf_counter() - start)
                    stats["completed"] += 1
                else:
                    stats["lost"] += 1
                    stats["lost_detail"].append(outcome[1])
        for c in conns.values():
            c.close()

    def probe_worker() -> None:
        # Mid-load, once traffic is established; the load stops only after
        # the probe's windows have closed.
        try:
            time.sleep(min(1.0, seconds / 4))
            probe_box.update(serve.get_deployment_handle("llm_decode", "llm").options(
                method_name="steady_rpc_probe").remote(
                    {"timeout_s": LLM_PROBE_TIMEOUT_S}).result(timeout=60))
        finally:
            probe_open.clear()

    workers = handle_threads + http_threads + (probe_box is not None)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        futures = ([pool.submit(handle_worker, i) for i in range(handle_threads)]
                   + [pool.submit(http_worker, i) for i in range(http_threads)])
        if probe_box is not None:
            futures.append(pool.submit(probe_worker))
        stats["during"] = during() if during else None
        for future in futures:
            future.result()
    stats["seconds"] = time.perf_counter() - t0
    return stats


def _llm_scaling_deploy(share: dict) -> float:
    """Deploys release/benchmarks_serve_llm.py's scaling app: a decode pool
    with a tiny KV pool (2 tokens a block, 64 blocks) and kv_headroom_min
    0.8, its decode replicas on the card too. Returns its seconds to
    RUNNING."""
    scaling = {"min_replicas": 1, "max_replicas": 2, "target_ongoing_requests": 1000,
               "upscale_delay_s": 0.5, "downscale_delay_s": 600.0}
    app = llm.build_llm_app(
        {"max_slots": 8, "slot_buckets": [8], "block_tokens": 2, "num_kv_blocks": 64,
         "decode_flops": 250_000},
        prefill_replicas=1, decode_replicas=1, prefill_autoscaling=scaling,
        decode_autoscaling={**scaling, "kv_headroom_min": 0.8}, request_timeout_s=120.0,
        decode_options={"ray_actor_options": share})
    t0 = time.perf_counter()
    serve.run(app, name="llmscale", route_prefix="/llmscale")
    return time.perf_counter() - t0


def _llm_scaling(ready_s: float) -> dict:
    """release/benchmarks_serve_llm.py's _scaling_phase on the deployed
    scaling app: ten loaders of 12-token prompts hold the free fraction near
    0.25, and the decode pool must grow from 1 to 2 while prefill stays
    at 1."""
    def replicas(dep: str) -> int:
        return serve.status().get("llmscale", {}).get("deployments", {}).get(dep, {}).get(
            "running_replicas", 0)

    stop, errors = threading.Event(), []
    prompt = " ".join(f"w{i}" for i in range(12))
    expect = llm_expected_tokens(prompt, 40)

    def loader(i: int) -> None:
        handle = serve.get_deployment_handle("llm_decode", "llmscale").options(
            method_name="generate")
        while not stop.is_set():
            try:
                out = handle.remote({"prompt": prompt, "max_tokens": 40,
                                     "request_id": f"scale-{i}-{time.monotonic_ns()}"}
                                    ).result(timeout=120)
            except Exception as exc:  # reported in scaling_load_errors
                if not stop.is_set():
                    errors.append(f"{type(exc).__name__}: {str(exc)[:160]}")
                return
            if out["tokens"] != expect:
                errors.append(f"wrong tokens: {out['tokens'][:4]!r}")

    threads = [threading.Thread(target=loader, args=(i,), daemon=True) for i in range(10)]
    for t in threads:
        t.start()
    decode_up = prefill_moved = False
    start = time.perf_counter()
    grow_s = None
    while time.perf_counter() - start < LLM_SCALE_WAIT_S:
        prefill_moved |= replicas("llm_prefill") > 1
        if replicas("llm_decode") >= 2:
            decode_up, grow_s = True, time.perf_counter() - start
            break
        time.sleep(0.25)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    prefill_moved |= replicas("llm_prefill") > 1
    metrics = _serve_metrics(serve.start(http_port=None), "llmscale_llm_decode")
    return {"decode_replicas_after": replicas("llm_decode"),
            "prefill_replicas_after": replicas("llm_prefill"),
            "pools_scale_independent": int(decode_up and not prefill_moved),
            "grow_s": grow_s, "ready_s": ready_s, "scaling_load_errors": errors[:3],
            "threads_left": sum(t.is_alive() for t in threads),
            "decode_pools": [(m["serve_llm"]["kv_device"], m["serve_llm"]["kv_pool_bytes"])
                             for m in metrics],
            "decode_leases": [(m["serve_llm"]["lease_cards"], m["serve_llm"]["current_device"])
                              for m in metrics],
            "kernels": [m["kernels"] for m in metrics]}


def phase_serve_llm(seconds: float = LLM_SECONDS) -> dict:
    """Phase 30: release/benchmarks_serve_llm.py's phases 1-3 on the port
    (module comment above), and the card's decode of the quantized KV wire.
    Gates: lost 0, every completed sequence's tokens equal to the digest,
    both kills landed and recovered, decode_controller_rpcs 0,
    pools_scale_independent 1, the decode pools on the card, the card's
    decode bitwise the plain one's."""
    start = time.perf_counter()
    codec = _llm_codec_on_card("cuda")
    share = {"num_gpus": LLM_GPU_SHARE}
    log("serve_llm_codec", **codec)
    port = _port_pair()
    ports = [port, port + 1]
    qname = "llm_llm_decode"
    # Traced throughout: the cluster starts inside, so that its node agent,
    # and every replica and proxy it starts, inherit the tracing
    # environment; every sequence is sampled. Every process of the cluster,
    # this one included once init() has run, exports its spans under the
    # cluster's session directory.
    with traced("serve_llm"):
        rt.init(num_cpus=32)
        session = runtime_worker.runtime_info()["session_dir"]
        try:
            try:
                # The second proxy's actor and the app's replicas start at once.
                controller = serve.start(http_port=port)
                background = concurrent.futures.ThreadPoolExecutor(1)
                second_proxy = background.submit(serve.start, http_port=port, num_proxies=2)
                app = llm.build_llm_app(
                    {"max_slots": 128, "slot_buckets": [32, 64, 128], "seq_trace_sample": 1.0},
                    prefill_replicas=1, decode_replicas=2, max_ongoing_requests=512,
                    request_timeout_s=60.0,
                    decode_options={"health_check_period_s": 1.0,
                                    "retry_policy": {"max_attempts": 8, "hedge": True},
                                    "ray_actor_options": share},
                    prefill_options={"retry_policy": {"max_attempts": 8, "hedge": True}})
                t0 = time.perf_counter()
                serve.run(app, name="llm", route_prefix="/llm")
                second_proxy.result(timeout=300)
                ready_s = time.perf_counter() - t0
                first_proxy_pid = next(p["pid"] for p in _ctl(controller, "get_proxies")
                                       if p["port"] == port)
                warm = _post_json(port, "/llm",
                                  {"prompt": LLM_PROMPT, "max_tokens": LLM_MAX_TOKENS})
                require(warm["tokens"] == llm_expected_tokens(LLM_PROMPT, LLM_MAX_TOKENS),
                        f"serve_llm: warm-up tokens {warm['tokens']}")
                # One warm-up on each decode replica (a session id the proxy's
                # ring sends there): the sampled request then meets no cold
                # replica whose first answer outlasts the hedge's delay.
                decode_names = long_poll.get_subscriber().get_replicas(qname)["actor_names"]
                ring = serve_routing.HashRing(decode_names)
                for name in decode_names:
                    key = next(f"warm-{i}" for i in range(4096) if ring.pick(f"warm-{i}") == name)
                    _post_json(port, "/llm", {"prompt": LLM_PROMPT, "max_tokens": LLM_MAX_TOKENS},
                               headers={"X-RayTPU-Session": key})
                # The sampled request, alone on the app: its decode iterations are
                # its own.
                traced_out = _post_json(
                    port, "/llm", {"prompt": LLM_PROMPT, "max_tokens": LLM_MAX_TOKENS,
                                   "request_id": LLM_TRACE_REQUEST},
                    headers={"X-RayTPU-Trace": f"{LLM_TRACE_ID}:{LLM_TRACE_PARENT}"})
                require(traced_out["tokens"] == llm_expected_tokens(LLM_PROMPT, LLM_MAX_TOKENS),
                        f"serve_llm: the traced request's tokens {traced_out['tokens']}")
                prefill_pids = sorted(m["pid"] for m in
                                      _ctl(controller, "get_metrics")["llm_llm_prefill"])

                def decode_running() -> int:
                    return serve.status()["llm"]["deployments"]["llm_decode"]["running_replicas"]

                # Phase 1: the baseline and the steady-state probe.
                probe: dict = {}
                baseline = _llm_load(seconds, LLM_HANDLE_THREADS, LLM_HTTP_THREADS, ports, probe)
                before = _serve_metrics(controller, qname)
                victims = sorted(m["pid"] for m in before)
                proxies = {p["port"]: p for p in _ctl(controller, "get_proxies")}
                require(len(victims) == 2 and proxies[port + 1]["pid"],
                        f"serve_llm: decode pids {victims}, proxies {proxies}")

                # Phase 2: a decode replica's process and the second proxy's killed
                # mid-window, at the load the surviving replica can carry alone.
                def kills() -> list:
                    events, t_kill = [], time.perf_counter()
                    for at, pid, what in ((LLM_KILL_REPLICA_S, victims[0], "replica"),
                                          (LLM_KILL_PROXY_S, proxies[port + 1]["pid"], "proxy")):
                        time.sleep(max(0.0, at - (time.perf_counter() - t_kill)))
                        try:
                            os.kill(pid, signal.SIGKILL)
                            events.append({"target": what, "pid": pid, "status": "ok",
                                           "at_s": time.perf_counter() - t_kill})
                        except ProcessLookupError:
                            events.append({"target": what, "pid": pid, "status": "gone"})
                    return events

                chaos = _llm_load(seconds, max(1, LLM_HANDLE_THREADS // 4), LLM_HTTP_THREADS, ports,
                                  during=kills)
                # Phase 3's app starts while the killed replica and proxy come back.
                scale_ready = background.submit(_llm_scaling_deploy, share)
                recover_start = time.perf_counter()
                recovered = proxy_back = False
                while time.perf_counter() - recover_start < LLM_RECOVER_S:
                    pids = {m["pid"] for m in _ctl(controller, "get_metrics").get(qname, [])}
                    recovered = decode_running() == 2 and victims[0] not in pids and len(pids) == 2
                    now = next(p for p in _ctl(controller, "get_proxies") if p["port"] == port + 1)
                    try:
                        proxy_back = now["restarts"] == 1 and _post_json(
                            port + 1, "/llm", {"prompt": LLM_PROMPT, "max_tokens": LLM_MAX_TOKENS}
                        )["tokens"] == llm_expected_tokens(LLM_PROMPT, LLM_MAX_TOKENS)
                    except (OSError, AssertionError):
                        proxy_back = False
                    if recovered and proxy_back:
                        break
                    time.sleep(0.5)
                recover_s = time.perf_counter() - recover_start
                after = _serve_metrics(controller, qname)

                # Phase 3: the tiny-pool app scales its decode pool on KV headroom.
                scaling = _llm_scaling(scale_ready.result(timeout=300))
                background.shutdown()
            finally:
                serve.shutdown()
            # The wire hop under the request's KV-transfer span; then the
            # chain read back and the observability bench's paired windows.
            kv_span = next((s for s in tracing.read_spans(session)
                            if s["trace_id"] == LLM_TRACE_ID
                            and s["name"] == "serve.kv_transfer"), None)
            wire = _llm_wire_trace({"trace_id": LLM_TRACE_ID,
                                    "span_id": (kv_span or {}).get("span_id", "0" * 16)})
            trace_check = _llm_trace_check(session, victims, prefill_pids, wire,
                                           first_proxy_pid)
            obs = _llm_obs_overhead("cuda")
        finally:
            rt.shutdown()
            shutil.rmtree(os.path.join(session, "tracing"), ignore_errors=True)
    OBSERVABILITY["serve_llm"] = {**trace_check, "bench_phase1": obs,
                                  "decode_controller_rpcs": probe.get("controller_rpcs", -1),
                                  "probe_window_iterations": probe.get("window_iterations", [])}
    log("serve_llm_trace", **trace_check)
    log("serve_llm_observability", **obs)

    base_p99 = _percentile_ms(baseline["http_latencies"], 0.99) if baseline[
        "http_latencies"] else 0.0
    chaos_p99 = _percentile_ms(chaos["http_latencies"], 0.99) if chaos[
        "http_latencies"] else 0.0
    events = chaos["during"]
    pools = [(m["serve_llm"]["kv_device"], m["serve_llm"]["kv_pool_bytes"])
             for m in before + after] + scaling["decode_pools"]
    # Read inside each decode replica: the cards its lease names, and the
    # device it opened.
    leases = [(m["serve_llm"]["lease_cards"], m["serve_llm"]["current_device"])
              for m in before + after] + scaling["decode_leases"]
    kernels = [m["kernels"] for m in before + after] + scaling["kernels"]
    result = dict(
        config="release/benchmarks_serve_llm.py phases 1-3, deployment and load uncut, "
               "4 s windows, the baseline's until the probe returns",
        seconds_window=seconds, ready_s=ready_s,
        baseline_seconds=baseline["seconds"],
        qps=baseline["completed"] / baseline["seconds"], release_gate_qps=LLM_RELEASE_GATE_QPS,
        sequences=baseline["completed"] + chaos["completed"],
        batch_waves=len(baseline["batch_latencies"]) + len(chaos["batch_latencies"]),
        batch_p50_ms=_percentile_ms(baseline["batch_latencies"], 0.5)
        if baseline["batch_latencies"] else 0.0,
        http_requests=len(baseline["http_latencies"]) + len(chaos["http_latencies"]),
        lost=baseline["lost"] + chaos["lost"], baseline_lost=baseline["lost"],
        lost_detail=(baseline["lost_detail"] + chaos["lost_detail"])[:5],
        shed=baseline["shed"] + chaos["shed"],
        handle_attempts_shed=baseline["attempts_shed"] + chaos["attempts_shed"],
        handle_shed_moves=baseline["shed_moves"] + chaos["shed_moves"],
        failovers=baseline["failovers"] + chaos["failovers"],
        baseline_p99_ms=base_p99, chaos_p99_ms=chaos_p99,
        p99_ratio=chaos_p99 / base_p99 if base_p99 else 0.0,
        replica_kills=sum(e["status"] == "ok" and e["target"] == "replica" for e in events),
        proxy_kills=sum(e["status"] == "ok" and e["target"] == "proxy" for e in events),
        kills=events, replicas_recovered=int(recovered), proxy_restarted=int(proxy_back),
        recover_s=recover_s,
        decode_controller_rpcs=probe.get("controller_rpcs", -1),
        probe_iterations=probe.get("iterations", 0),
        probe_window_iterations=probe.get("window_iterations", []),
        probe_rpc_methods=probe.get("rpc_methods", {}),
        engine_before={m["pid"]: {k: m["serve_llm"][k] for k in
                                  ("iterations", "admitted", "completed", "shed", "expired",
                                   "kv_wire_err", "iter_rate_s")} for m in before},
        decode_pools=pools, decode_leases=leases, codec=codec,
        **{k: scaling[k] for k in ("decode_replicas_after", "prefill_replicas_after",
                                   "pools_scale_independent", "grow_s", "scaling_load_errors",
                                   "threads_left")},
        scaling_ready_s=scaling["ready_s"], phase_seconds=time.perf_counter() - start)
    log("serve_llm", **result)
    require(result["lost"] == 0, f"serve_llm: {result['lost']} lost: {result['lost_detail']}")
    require(result["replica_kills"] == 1 and result["proxy_kills"] == 1,
            f"serve_llm: kills {events}")
    require(result["replicas_recovered"] == 1, "serve_llm: the killed decode replica not replaced")
    require(result["proxy_restarted"] == 1, "serve_llm: the killed proxy not restarted")
    require(result["decode_controller_rpcs"] == 0 and probe["best_window_iterations"] >= 100,
            f"serve_llm: steady probe {probe}")
    require(result["pools_scale_independent"] == 1 and not scaling["scaling_load_errors"]
            and not scaling["threads_left"],
            f"serve_llm: scaling {scaling}")
    require(len(pools) >= 5 and all(dev.startswith("cuda") and nbytes > 0
                                    for dev, nbytes in pools),
            f"serve_llm: decode pools {pools}")
    require(all(cards == "0" and current == 0 for cards, current in leases),
            f"serve_llm: decode replicas' leases and devices {leases}")
    require(all(codec[q]["bitwise"] and codec[q]["pool_device"].startswith("cuda")
                for q in codec), f"serve_llm: the card's KV decode {codec}")
    require(trace_check["ok"], f"serve_llm: the sampled request's trace {trace_check}")
    require(obs["overhead_pct"] <= LLM_OBS_HOLD_PCT,
            f"serve_llm: observability overhead {obs['overhead_pct']:.3f}% above "
            f"{LLM_OBS_HOLD_PCT}%")
    result["replica_kernels"] = kernels
    return result


# ---------------------------------------------------------------- phase 31: the runtime core
# ray_tpu_torch.init() with no arguments on the card's host: a controller, a
# node agent with its store, and workers started with `python -m
# ray_tpu_torch._private.worker_proc` (they never import this script again:
# the classes and functions below reach them by value). The agent counts the
# card through nvidia-smi and never opens a context on it; a worker sees
# only its lease's card through CUDA_VISIBLE_DEVICES.
RUNTIME_LAYERS = 32          # uncut: the actor's build takes well under 15 s
RUNTIME_BATCH, RUNTIME_SEQ = 8, 512
RUNTIME_CALLS = 3
RUNTIME_OBJECT_BYTES = 1 << 30
RUNTIME_LEASE_WAIT_S = 10.0
DEVICE_SMI = None            # phase 1's nvidia-smi line: name, power limit
RUNTIME_TMP = Path(__file__).resolve().parent / "build" / "chip_smoke_runtime"


def _runtime_card_task(marker: str, peer: str) -> dict:
    """A task at num_gpus=0.5: its CUDA_VISIBLE_DEVICES, and B4 launched
    once at the serve shape against its plain version, while the other
    half-card task runs (each waits for the other's marker)."""
    import os
    import time

    import torch

    from ray_tpu_torch.ops import rmsnorm as rm

    open(marker, "w").close()
    deadline = time.monotonic() + 60
    while not os.path.exists(peer) and time.monotonic() < deadline:
        time.sleep(0.01)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(RUNTIME_BATCH * RUNTIME_SEQ, 4096, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.randn(4096, generator=gen, device="cuda", dtype=torch.bfloat16)
    rm.rmsnorm.launches = 0
    y = rm.rmsnorm(x, w)
    launches = rm.rmsnorm.launches
    plain = rm.rmsnorm_reference(x, w)
    torch.cuda.synchronize()
    return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": torch.cuda.get_device_name(0), "device_count": torch.cuda.device_count(),
            "peer_seen": os.path.exists(peer), "launches": launches,
            "max_abs_err": float((y.float() - plain.float()).abs().max()),
            "ulps": ulps(y, plain)}


def _runtime_cpu_task() -> dict:
    import os

    import torch

    return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda_available": torch.cuda.is_available()}


def _bits_digest(t: torch.Tensor) -> list:
    """Two sums over a float32 tensor's bit patterns, on its device: equal
    digests of equal-shaped tensors mean equal bits but for a collision."""
    bits = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    weights = torch.arange(bits.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
    return [int(bits.sum()), int((bits * weights).sum())]


class RuntimeModel:
    """TransformerConfig.llama2_7b() in bf16 from seed 0 on the actor's card,
    its logits for the driver's tokens computed at construction, and the
    launch counts of the remote forwards."""

    def __init__(self, layers: int, tokens):
        import os
        import time

        import torch

        from ray_tpu_torch.models.transformer import TransformerConfig, forward, init_params

        self.pid = os.getpid()
        self.visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        start = time.perf_counter()
        self.config = TransformerConfig.llama2_7b(n_layers=layers)
        self.params = init_params(self.config, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - start
        self.forward = forward
        with torch.no_grad():
            self.expected = forward(self.params, self._tokens(tokens), self.config)
        torch.cuda.synchronize()
        self.expected_digest = _bits_digest(self.expected)
        self.forward_ms: list = []
        flash_mod.reset_launch_counts()
        rmsnorm_mod.rmsnorm.launches = 0

    @staticmethod
    def _tokens(tokens):
        return torch.as_tensor(np.asarray(tokens), dtype=torch.int64).cuda()

    def info(self) -> dict:
        return {"pid": self.pid, "cuda_visible_devices": self.visible, "build_s": self.build_s,
                "layers": self.config.n_layers, "device": torch.cuda.get_device_name(0),
                "expected_digest": self.expected_digest,
                "expected_shape": list(self.expected.shape)}

    def run(self, tokens):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        tokens = self._tokens(tokens)
        with torch.no_grad():
            start.record()
            logits = self.forward(self.params, tokens, self.config)
            end.record()
        torch.cuda.synchronize()
        self.forward_ms.append(start.elapsed_time(end))
        return logits

    def counts(self) -> dict:
        return {"counts": _counts(), "routes": _route_counts(), "forward_ms": self.forward_ms}

    def d2h_ms(self) -> float:
        """One device-to-host copy of logits the size of a forward's, the
        copy the store's write of a returned CUDA tensor makes."""
        import time

        torch.cuda.synchronize()
        start = time.perf_counter()
        self.expected.cpu()
        return (time.perf_counter() - start) * 1e3

    def sums(self, tensor, array) -> list:
        """The two objects' sums, on the card, in float64."""
        return [float(tensor.cuda().double().sum()), float(torch.from_numpy(
            np.asarray(array)).cuda().double().sum())]


class RuntimeProbe:
    """A small actor on the card: answers with its pid and the card's name,
    or holds a call open while it is killed."""

    def where(self) -> dict:
        import os

        return {"pid": os.getpid(), "device": torch.cuda.get_device_name(0),
                "on_card": float(torch.ones(4, device="cuda").sum()),
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def hold(self, ref_value) -> None:
        import time

        time.sleep(120)


def _runtime_processes() -> list:
    """Pids of this host's processes of the port's runtime."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if "ray_tpu_torch._private." in cmd and int(entry) != os.getpid():
            pids.append(int(entry))
    return pids


def _card_files(pid: int) -> list:
    """The NVIDIA device files a process holds open: a process with a CUDA
    context holds /dev/nvidiactl, a card's /dev/nvidia<N> and
    /dev/nvidia-uvm."""
    held = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        with contextlib.suppress(OSError):
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
            if target.startswith("/dev/nvidia"):
                held.add(target)
    return sorted(held)


def _compute_app_pids() -> set:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return {int(p) for p in out.split() if p.strip().isdigit()}


def _until(predicate, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while True:
        value = predicate()
        if value:
            return value
        require(time.monotonic() < deadline, f"runtime: {what} not within {timeout_s} s")
        time.sleep(0.05)


def _runtime_kill_held(rt, exceptions_mod, probe, pid: int) -> None:
    """SIGKILLs the probe's process while a call of it is held open: an
    argument by ref takes the runtime's slow path, whose call fails as soon
    as the connection closes and drops the driver's cached address."""
    held = probe.hold.remote(rt.put(0))
    time.sleep(0.5)
    os.kill(pid, signal.SIGKILL)
    with contextlib.suppress(exceptions_mod.RayTpuError):
        rt.get(held, timeout=60)


def _runtime_restart_probe(rt, exceptions_mod, ctx) -> dict:
    """(e): a num_gpus=1, max_restarts=1 actor SIGKILLed twice. Before the
    next call the driver waits for the controller to record the death (a
    call that raced it would redial the dead address for the reference's
    11-13 s of backoff first)."""
    probe = rt.remote(num_gpus=1, max_restarts=1)(RuntimeProbe).remote()
    first = rt.get(probe.where.remote(), timeout=120)

    def state():
        return ctx.io.run(ctx.controller.call("get_actor_info", {"actor_id": probe._actor_id}))

    old = state()["address"]
    t0 = time.perf_counter()
    _runtime_kill_held(rt, exceptions_mod, probe, first["pid"])
    _until(lambda: (lambda s: s["state"] == "ALIVE" and s["address"] != old)(state()), 60,
           "the probe's restart")
    restarted_s = time.perf_counter() - t0
    second = rt.get(probe.where.remote(), timeout=60)
    restart_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    _runtime_kill_held(rt, exceptions_mod, probe, second["pid"])
    _until(lambda: state()["state"] == "DEAD", 30, "the probe's death")
    try:
        rt.get(probe.where.remote(), timeout=60)
        ended = "answered"
    except exceptions_mod.ActorDiedError:
        ended = "ActorDiedError"
    death_s = time.perf_counter() - t1
    _until(lambda: rt.available_resources().get("GPU") == 1.0, RUNTIME_LEASE_WAIT_S,
           "the probe's lease back after its death")
    lease_back_s = time.perf_counter() - t1
    require(second["pid"] != first["pid"] and second["device"] == first["device"]
            and second["on_card"] == 4.0 and second["cuda_visible_devices"] == "0",
            f"runtime: restarted probe {first} -> {second}")
    require(ended == "ActorDiedError", f"runtime: the second kill ended the probe with {ended}")
    return {"first_pid": first["pid"], "second_pid": second["pid"],
            "kill_to_alive_s": restarted_s, "restart_s": restart_s,
            "second_kill_to_died_s": death_s, "lease_back_s": lease_back_s, "ended": ended}


def phase_runtime() -> dict:
    """Phase 31: the runtime core on the card's host, through the public API."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import _native
    from ray_tpu_torch import exceptions as exceptions_mod
    from ray_tpu_torch._private import ray_perf
    from ray_tpu_torch._private import worker as worker_mod

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(0)
    start = time.perf_counter()
    rt.init()
    init_s = time.perf_counter() - start
    result = {"init_s": init_s}
    try:
        # (a) the cluster: the card counted, no context in the daemons, and
        # every native plane on.
        total = rt.cluster_resources()
        name_key = "GPU-" + name.replace(" ", "-")
        require(total.get("GPU") == 1.0 and total.get(name_key) == 1.0,
                f"runtime: cluster_resources {total}, GPU 1 and {name_key} 1 expected")
        ctx = worker_mod.get_global_context()
        cluster = worker_mod._local_cluster
        daemons = {"controller": cluster.controller_handle.proc.pid,
                   "agent": cluster.agents[0].proc.pid}
        agent_stats = ctx.io.run(ctx.agent.call("store_stats", {}))
        planes = {"engine": ctx._engine is not None and bool(ctx._engine.stats()),
                  "fast_lane": ctx._fastlane is not None,
                  "lease_lane": "native_lease" in agent_stats,
                  "agent_engine": bool(agent_stats.get("engine"))}
        require(planes["engine"] and planes["lease_lane"] and planes["agent_engine"],
                f"runtime: native planes {planes}")
        require(planes["fast_lane"] or _native.fastlane_off_reason is not None,
                f"runtime: the fast lane is off with no reason recorded {planes}")
        result["cluster"] = {"resources": total, "daemons": daemons, "planes": planes,
                             "fastlane_off_reason": _native.fastlane_off_reason,
                             "agent_stats": {k: agent_stats.get(k) for k in
                                             ("native_lease", "capacity", "engine")}}

        # (b) two half-card tasks at once, and a CPU task, started together.
        # Tasks of one shape pipeline through one leased worker (the
        # reference's dispatcher, below a depth of 4), so the two differ in
        # their CPUs.
        tmp = RUNTIME_TMP
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        card_task = rt.remote(num_gpus=0.5)(_runtime_card_task)
        a, b = str(tmp / "a"), str(tmp / "b")
        start = time.perf_counter()
        refs = [card_task.remote(a, b), card_task.options(num_cpus=2).remote(b, a),
                rt.remote(_runtime_cpu_task).remote()]
        half_a, half_b, cpu = rt.get(refs, timeout=120)
        sharing_s = time.perf_counter() - start
        for task in (half_a, half_b):
            require(task["cuda_visible_devices"] == "0" and task["device_count"] == 1
                    and task["peer_seen"] and task["launches"] == 1,
                    f"runtime: half-card task {task}")
            require(task["ulps"] <= RMSNORM_BF16_ULPS,
                    f"runtime: a task's B4 against its plain version {task}")
        require(half_a["pid"] != half_b["pid"], "runtime: the half-card tasks shared a process")
        require(cpu == {"cuda_visible_devices": "", "cuda_available": False},
                f"runtime: the CPU task saw {cpu}")
        _until(lambda: rt.available_resources().get("GPU") == 1.0, RUNTIME_LEASE_WAIT_S,
               "the half-card leases back")
        result["sharing"] = {"tasks": [half_a, half_b], "cpu_task": cpu, "seconds": sharing_s}

        # (c) the model behind a num_gpus=1 actor, 3 remote forwards.
        rng = np.random.default_rng(SEED)
        tokens = rng.integers(0, 32000, (RUNTIME_BATCH, RUNTIME_SEQ)).astype(np.int32)
        start = time.perf_counter()
        model = rt.remote(num_gpus=1)(RuntimeModel).remote(RUNTIME_LAYERS, tokens)
        info = rt.get(model.info.remote(), timeout=300)
        actor_ready_s = time.perf_counter() - start
        require(info["cuda_visible_devices"] == "0" and info["device"] == name,
                f"runtime: the model actor {info}")
        tokens_ref = rt.put(tokens)
        calls = []
        for _ in range(RUNTIME_CALLS):
            start = time.perf_counter()
            logits = rt.get(model.run.remote(tokens_ref), timeout=300)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - start) * 1e3
            require(logits.is_cuda and logits.dtype == torch.float32
                    and list(logits.shape) == info["expected_shape"]
                    and logits.device.index == torch.cuda.current_device(),
                    f"runtime: logits {logits.dtype} {tuple(logits.shape)} on {logits.device}")
            calls.append({"call_ms": call_ms,
                          "bitwise": _bits_digest(logits) == info["expected_digest"],
                          "finite": bool(torch.isfinite(logits).all())})
            del logits
        counted = rt.get(model.counts.remote(), timeout=60)
        d2h_ms = rt.get(model.d2h_ms.remote(), timeout=60)
        host = torch.empty(info["expected_shape"], dtype=torch.float32)
        torch.cuda.synchronize()
        start = time.perf_counter()
        host.cuda()
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - start) * 1e3
        del host
        require(all(c["bitwise"] and c["finite"] for c in calls),
                f"runtime: logits across the store {calls}")
        call_ms = statistics.median(c["call_ms"] for c in calls)
        forward_ms = statistics.median(counted["forward_ms"])
        result["model"] = {
            "config": "llama2_7b", "layers": info["layers"], "build_s": info["build_s"],
            "actor_ready_s": actor_ready_s, "calls": calls, "logits_bytes":
            4 * int(np.prod(info["expected_shape"])), "call_ms": call_ms,
            "forward_ms": forward_ms, "d2h_ms": d2h_ms, "h2d_ms": h2d_ms,
            "store_and_rpc_ms": call_ms - forward_ms - d2h_ms - h2d_ms,
            "counts": counted["counts"], "routes": counted["routes"]}

        # (d) objects: 1 GiB of CPU bf16 and 1 GiB of numpy through put/get,
        # and their refs to the actor, which sums them on the card.
        # Integers (bf16 holds 0-255 exactly), made on the card: the sums
        # in float64 are exact on either side.
        tensor = (torch.arange(RUNTIME_OBJECT_BYTES // 2, device="cuda", dtype=torch.int32)
                  % 256).to(torch.bfloat16).cpu()
        array = (torch.arange(RUNTIME_OBJECT_BYTES // 4, device="cuda", dtype=torch.int32)
                 % 1000).float().cpu().numpy()
        puts = {}
        for label, value in (("tensor_bf16", tensor), ("numpy_f32", array)):
            start = time.perf_counter()
            ref = rt.put(value)
            seconds = time.perf_counter() - start
            first, second = rt.get(ref, timeout=120), rt.get(ref, timeout=120)
            if label == "numpy_f32":
                zero_copy = (not first.flags.writeable) and np.shares_memory(first, second)
                equal = bool(np.array_equal(first, value))
            else:
                zero_copy = first.data_ptr() == second.data_ptr() != value.data_ptr()
                equal = bool(torch.equal(first, value))
            puts[label] = {"ref": ref, "put_s": seconds, "gb_per_s": RUNTIME_OBJECT_BYTES / seconds
                           / 1e9, "zero_copy": zero_copy, "equal": equal}
            del first, second
        sums = rt.get(model.sums.remote(puts["tensor_bf16"]["ref"], puts["numpy_f32"]["ref"]),
                      timeout=300)
        want = [float(tensor.cuda().double().sum()),
                float(torch.from_numpy(array).cuda().double().sum())]
        require(all(p["zero_copy"] and p["equal"] for p in puts.values()),
                f"runtime: puts {puts}")
        require(sums == want, f"runtime: the actor's sums {sums}, the driver's {want}")
        result["objects"] = {k: {f: v for f, v in p.items() if f != "ref"}
                             for k, p in puts.items()}
        result["objects"]["sums"] = sums
        del tensor, array, puts

        # The daemons hold no context on the card while a worker drives it:
        # neither is among nvidia-smi's compute apps (which name this
        # container's processes by the host's pids, if at all), nor holds a
        # card's device file open, as the model actor's process does.
        apps = _compute_app_pids()
        files = {name: _card_files(pid) for name, pid in
                 {**daemons, "model_actor": info["pid"]}.items()}
        require(not set(daemons.values()) & apps
                and not files["controller"] and not files["agent"] and files["model_actor"],
                f"runtime: CUDA contexts {daemons} {apps} {files}")
        result["cluster"]["compute_apps"] = sorted(apps)
        result["cluster"]["card_files"] = files

        # (e) faults: the model actor killed, its lease back; the probe's
        # restart on the card and its death.
        start = time.perf_counter()
        rt.kill(model)
        _until(lambda: rt.available_resources().get("GPU") == 1.0, RUNTIME_LEASE_WAIT_S,
               "the model actor's lease back after kill")
        result["faults"] = {"kill_lease_back_s": time.perf_counter() - start}
        result["faults"].update(_runtime_restart_probe(rt, exceptions_mod, ctx))

        # (f) the reference's microbenchmark on this host.
        result["microbenchmark"] = ray_perf.main()
    finally:
        rt.shutdown()
        shutil.rmtree(RUNTIME_TMP, ignore_errors=True)
    left = _runtime_processes()
    arenas = [n for n in os.listdir("/dev/shm") if n.startswith("raytpu_torch-")]
    require(not left and not arenas,
            f"runtime: shutdown left processes {left} and arenas {arenas}")
    result["seconds"] = time.perf_counter() - t_phase
    return result


def _path(name: str, want: dict, counts: dict, routes: dict, route: str, **fields) -> None:
    """Logs a path's launch counts and fails unless they are what the path
    implies and every flash launch took `route`."""
    log("launches", path=name, counts=counts, routes=routes, expected=want, **fields)
    require(counts == want, f"{name}: kernel launches do not match the path")
    for kernel, by_route in routes.items():
        require(by_route[route] == counts[kernel] and sum(by_route.values()) == counts[kernel],
                f"{name}: {kernel} launches by route {by_route}, {counts[kernel]} in all")


def _replica_paths(name: str, layers: int, by_pid: dict) -> tuple:
    """Holds each replica's launch counts (pid: (counts, routes, forwards))
    to what its forwards imply, every flash launch on the mma.sync route;
    returns the replicas' counts and routes summed."""
    counts: dict = {}
    routes: dict = {}
    for pid, (mine, my_routes, forwards) in sorted(by_pid.items()):
        _path(f"{name}[{pid}]", _expected(layers, kernel_forwards=forwards), mine, my_routes,
              "mma_sync", forwards=forwards)
        for k, n in mine.items():
            counts[k] = counts.get(k, 0) + n
        for k, by_route in my_routes.items():
            routes.setdefault(k, {r: 0 for r in by_route})
            for r, n in by_route.items():
                routes[k][r] += n
    require(len(by_pid) == 2, f"{name}: launch counts of {len(by_pid)} replicas, 2 expected")
    return counts, routes


def _run_path(fn, *args) -> tuple:
    """fn(*args) with every count set to 0 just before it; returns its
    result and the counts and routes read just after."""
    reset_counts()
    result = fn(*args)
    return result, _counts(), _route_counts()


def main() -> None:
    global DEVICE_SMI
    DEVICE_SMI = phase_device()
    counts, routes = {}, {}
    # Phase 30: the serve-LLM engine, beside the build (nvcc and g++ in
    # their own processes), since it needs no kernel of the port. Its
    # decode replicas (on the card) and its prefill replicas launch none:
    # their counts come back through their kernel_launches, each 0, and
    # this process launches none. Its init() waits on the file lock of the
    # runtime's native build when the build holds it, so the two never
    # build the same library at once.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        build = pool.submit(phase_build)
        t0 = time.perf_counter()
        llm_run, counts["serve_llm"], routes["serve_llm"] = _run_path(phase_serve_llm)
        llm_wall = time.perf_counter() - t0
        ptxas = build.result()
    replica_launches = [v["launches"] for k in llm_run["replica_kernels"] for v in k.values()]
    require(not any(replica_launches), f"serve_llm: replica launches {replica_launches}")
    _path("serve_llm", {k: 0 for k in counts["serve_llm"]}, counts["serve_llm"],
          routes["serve_llm"], "wgmma")
    entries = phase_kernels()
    for e in entries:  # ptxas's report beside the kernels of each entry's shape
        names = e.pop("ptxas_names", None) or PTXAS_NAMES[e["name"]]
        e["ptxas"] = {k: v for k, v in ptxas.items() if any(part in k for part in names)}

    start = time.perf_counter()
    config = TransformerConfig.llama2_7b()
    params = init_params(config, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log("params", config="llama2_7b", layers=config.n_layers, dim=config.dim,
        dtype=str(config.dtype), seconds=time.perf_counter() - start,
        gib=torch.cuda.memory_allocated() / 2**30)

    # Each path runs with every count set to 0 just before it.
    torch.cuda.reset_peak_memory_stats()
    (serve, gen), counts["serve"], routes["serve"] = _run_path(
        lambda: (phase_serve(params, config), phase_generate(params, config)))
    forwards = serve["forwards"] + gen["forwards"]
    _path("serve", _expected(config.n_layers, kernel_forwards=forwards,
                             decode_steps=gen["decode_steps"]),
          counts["serve"], routes["serve"], "wgmma", forwards=forwards,
          decode_steps=gen["decode_steps"], peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del params
    torch.cuda.empty_cache()

    train, counts["train"], routes["train"] = _run_path(phase_train)
    passes = {k: train[k] for k in ("kernel_forwards", "kernel_backwards", "plain_forwards")}
    _path("train", _expected(TRAIN_CONFIG["n_layers"], **passes), counts["train"],
          routes["train"], "wgmma", **passes)
    torch.cuda.empty_cache()

    tiny, counts["tiny"], routes["tiny"] = _run_path(phase_tiny)
    passes = {k: tiny[k] for k in ("kernel_forwards", "kernel_backwards", "plain_forwards")}
    _path("tiny", _expected(TransformerConfig.tiny().n_layers, **passes), counts["tiny"],
          routes["tiny"], "mma_sync", **passes)

    start = time.perf_counter()
    config = moe_config(MOE_SERVE_LAYERS)
    params = init_params(config, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log("params", config="llama2_7b(moe=MoEConfig(), n_layers=4)", layers=config.n_layers,
        params=num_params(params), seconds=time.perf_counter() - start,
        gib=torch.cuda.memory_allocated() / 2**30)
    torch.cuda.reset_peak_memory_stats()
    moe_serve, counts["moe_serve"], routes["moe_serve"] = _run_path(
        phase_moe_serve, params, config)
    _path("moe_serve", _expected(config.n_layers, kernel_forwards=moe_serve["forwards"]),
          counts["moe_serve"], routes["moe_serve"], "wgmma", forwards=moe_serve["forwards"])
    stages, counts["stages"], routes["stages"] = _run_path(phase_stages, params, config)
    _path("stages", _expected(config.n_layers, kernel_forwards=stages["forwards"]),
          counts["stages"], routes["stages"], "wgmma", forwards=stages["forwards"])
    del params
    torch.cuda.empty_cache()

    moe_train, counts["moe_train"], routes["moe_train"] = _run_path(phase_moe_train)
    passes = {k: moe_train[k] for k in ("kernel_forwards", "kernel_backwards", "plain_forwards")}
    _path("moe_train", _expected(MOE_TRAIN_LAYERS, **passes), counts["moe_train"],
          routes["moe_train"], "wgmma", **passes)
    torch.cuda.empty_cache()

    sharded, counts["sharded_train"], routes["sharded_train"] = _run_path(phase_sharded_train)
    passes = {k: sharded[k] for k in ("kernel_forwards", "kernel_backwards", "plain_forwards")}
    _path("sharded_train", _expected(SHARDED_CONFIG["n_layers"], **passes),
          counts["sharded_train"], routes["sharded_train"], "wgmma", **passes,
          collective_calls=sharded["collective_calls"])

    phase_collectives()
    walls = {}
    # The trainer path's kernels launch in its worker processes, which
    # count from 0 and report their counts; this process's stay at 0.
    t0 = time.perf_counter()
    trainer, local, _ = _run_path(phase_trainer, sharded["step_ms"])
    walls["trainer"] = time.perf_counter() - t0
    require(not any(local.values()), f"trainer: launches in the driver process {local}")
    counts["trainer"], routes["trainer"] = trainer["counts"], trainer["routes"]
    passes = {k: trainer[k] for k in ("kernel_forwards", "kernel_backwards", "plain_forwards")}
    _path("trainer", _expected(TRAINER_LAYERS, **passes), counts["trainer"],
          routes["trainer"], "wgmma", **passes)

    sp, counts["sequence_parallel"], routes["sequence_parallel"] = _run_path(
        phase_sequence_parallel)
    _path("sequence_parallel", sp["want"], counts["sequence_parallel"],
          routes["sequence_parallel"], "wgmma")
    pipe, counts["pipeline"], routes["pipeline"] = _run_path(phase_pipeline)
    _path("pipeline", pipe["want"], counts["pipeline"], routes["pipeline"], "wgmma")

    ep, counts["expert_parallel"], routes["expert_parallel"] = _run_path(phase_expert_parallel)
    passes = {k: ep[k] for k in ("kernel_forwards", "kernel_backwards")}
    _path("expert_parallel", _expected(MOE_TRAIN_LAYERS, **passes), counts["expert_parallel"],
          routes["expert_parallel"], "wgmma", **passes)
    lora, counts["lora"], routes["lora"] = _run_path(phase_lora)
    _path("lora", lora["want"], counts["lora"], routes["lora"], "wgmma")
    # The CNN and the ResNet launch none of the port's kernels.
    cnn, counts["cnn"], routes["cnn"] = _run_path(phase_cnn)
    _path("cnn", {k: 0 for k in counts["cnn"]}, counts["cnn"], routes["cnn"], "wgmma")
    # The RLlib learner runs on the card (phase 20 checks its parameters'
    # device and the profiled update's device work) and launches none of
    # the port's kernels.
    rl, counts["rllib"], routes["rllib"] = _run_path(phase_rllib)
    _path("rllib", {k: 0 for k in counts["rllib"]}, counts["rllib"], routes["rllib"], "wgmma")
    rl2, counts["rllib_offpolicy"], routes["rllib_offpolicy"] = _run_path(phase_rllib_offpolicy)
    _path("rllib_offpolicy", {k: 0 for k in counts["rllib_offpolicy"]},
          counts["rllib_offpolicy"], routes["rllib_offpolicy"], "wgmma")
    # The profiler: (a) runs in this process; (b)'s kernels launch in its
    # worker, whose counts come back in its reports, as phase 14's do.
    t0 = time.perf_counter()
    prof, counts["profiler"], routes["profiler"] = _run_path(phase_profiler)
    walls["profiler"] = time.perf_counter() - t0
    passes = {k: prof[k] for k in ("kernel_forwards", "kernel_backwards", "plain_forwards")}
    _path("profiler", _expected(TRAIN_CONFIG["n_layers"], **passes), counts["profiler"],
          routes["profiler"], "wgmma", **passes)
    counts["profiler_trainer"] = prof["trainer"]["counts"]
    routes["profiler_trainer"] = prof["trainer"]["routes"]
    steps = prof["trainer"]["steps"]
    _path("profiler_trainer", _expected(SHARDED_CONFIG["n_layers"], kernel_forwards=steps,
                                        kernel_backwards=steps),
          counts["profiler_trainer"], routes["profiler_trainer"], "wgmma")

    # The HTTP serving path: its kernels launch in the replica actors, whose
    # counts (from 0 with each process) come back through their
    # kernel_launches; this process's launches are the direct forwards its
    # check ran.
    http, local, _ = _run_path(phase_serve_http)
    require(local == _expected(BERT_CONFIG["n_layers"], kernel_forwards=1),
            f"serve_http: this process launched {local}, one direct forward's worth expected")
    counts["serve_http"], routes["serve_http"] = http["counts"], http["routes"]
    _path("serve_http", _expected(BERT_CONFIG["n_layers"], kernel_forwards=http["forwards"]),
          counts["serve_http"], routes["serve_http"], "mma_sync", forwards=http["forwards"],
          replicas=http["replicas_reached"])

    # Tune: the trials are runtime actors (and a trainer trial's worker
    # another), whose reports carry their launch counts (phase 24 requires
    # 0); this process launches none.
    t0 = time.perf_counter()
    tuned, counts["tune"], routes["tune"] = _run_path(phase_tune, cnn["resnet"]["img_per_s"])
    walls["tune"] = time.perf_counter() - t0
    _path("tune", {k: 0 for k in counts["tune"]}, counts["tune"], routes["tune"], "wgmma")

    # Elasticity and config 1: (b)'s decoder launches its kernels in its
    # worker processes, whose counts come back in their reports; config 1's
    # CNN and the churn's quadratic launch none (their workers report 0),
    # and this process launches none.
    t0 = time.perf_counter()
    elastic, local, _ = _run_path(phase_elastic)
    walls["elastic"] = time.perf_counter() - t0
    require(not any(local.values()), f"elastic: launches in the driver process {local}")
    down = elastic["step_down"]
    counts["elastic"], routes["elastic"] = down["counts"], down["routes"]
    _path("elastic", _expected(ELASTIC_LAYERS, kernel_forwards=down["kernel_forwards"],
                               kernel_backwards=down["kernel_backwards"]),
          counts["elastic"], routes["elastic"], "wgmma")

    # The data plane and config 1 fed by it: the CNN launches none of the
    # port's kernels (its worker reports 0), nor does this process.
    t0 = time.perf_counter()
    data, counts["data"], routes["data"] = _run_path(
        phase_data, elastic["config1"]["card_img_per_s"])
    walls["data"] = time.perf_counter() - t0
    _path("data", {k: 0 for k in counts["data"]}, counts["data"], routes["data"], "wgmma")

    # Phase 27: the multiplexed replicas, then the chaos bench. Their kernels
    # launch in the replicas, whose counts come back through their
    # kernel_launches (a
    # killed replica's with it: (b) reads the survivor's and the
    # replacement's); this process's launches are its direct forwards.
    bert_layers = BERT_CONFIG["n_layers"]
    mux, local, _ = _run_path(phase_serve_mux)
    require(local == _expected(bert_layers, kernel_forwards=mux["direct_forwards"]),
            f"serve_mux: this process launched {local}, its direct forwards' worth expected")
    counts["serve_mux"], routes["serve_mux"] = _replica_paths(
        "serve_mux", bert_layers, {pid: (*mux["counts_by_pid"][pid], rep["forwards"])
                                   for pid, rep in mux["replicas"].items()})
    chaos, local, _ = _run_path(phase_serve_chaos)
    require(local == _expected(bert_layers, kernel_forwards=1),
            f"serve_chaos: this process launched {local}, one direct forward's worth expected")
    counts["serve_chaos"], routes["serve_chaos"] = _replica_paths(
        "serve_chaos", bert_layers, chaos["counts_by_pid"])

    # Phase 28: compiled graphs. The pipeline's kernels launch in its two
    # stage actors, whose counts (set to 0 in each before the graph runs)
    # come back by call, each held to its stage's layers; this process's
    # launches are its own stage_forward chains, which the outputs are held
    # against, and none during the graph's executions.
    dag_config = TransformerConfig.llama2_7b(n_layers=DAG_LAYERS)
    t0 = time.perf_counter()
    dagr, local, _ = _run_path(phase_dag, dag_config)
    walls["dag"] = time.perf_counter() - t0
    pipe28 = dagr["pipeline"]
    counts["dag"], routes["dag"] = _dag_paths(pipe28, local, dag_config)

    # Phase 29: the ring. The training's kernels launch in the two ring
    # members of each run, whose counts (from 0 in each process) come back
    # over the ring in rank 0's reports, each member held to its steps;
    # this process runs the codec alone and launches none.
    t0 = time.perf_counter()
    ring, local, _ = _run_path(phase_ring)
    walls["ring"] = time.perf_counter() - t0
    require(not any(local.values()), f"ring: launches in the driver process {local}")
    counts["ring"], routes["ring"] = ring["counts"], ring["routes"]
    _path("ring", _expected(RING_LAYERS, kernel_forwards=ring["kernel_forwards"],
                            kernel_backwards=ring["kernel_backwards"]),
          counts["ring"], routes["ring"], "wgmma")

    walls["serve_llm"] = llm_wall  # phase 30 ran beside the build

    # Phase 31: the runtime core. The model's kernels launch in its actor,
    # whose counts (set to 0 after its construction) come back by call, held
    # to its 3 forwards; the half-card tasks' B4 launches are comparisons
    # against the plain version, and this process launches none.
    t0 = time.perf_counter()
    runtime, local, _ = _run_path(phase_runtime)
    walls["runtime"] = time.perf_counter() - t0
    require(not any(local.values()), f"runtime: launches in the driver process {local}")
    model31 = runtime["model"]
    counts["runtime"], routes["runtime"] = model31["counts"], model31["routes"]
    _path("runtime", _expected(model31["layers"], kernel_forwards=RUNTIME_CALLS),
          counts["runtime"], routes["runtime"], "wgmma", forwards=RUNTIME_CALLS)
    log("runtime", **runtime, nvidia_smi=DEVICE_SMI)

    # Every launch on the tiny path is of its instantiations (head_dim 16 in
    # f32, RMSNorm at dim 64 in f32), on the HTTP serving path of BERT-base's
    # (head_dim 64 and dim 768 in bf16); on every other path, of the model's.
    for e in entries:
        kernel = e["name"].split("[")[0]
        if "instantiation" in e:
            # Serving runs no backward.
            paths = [p for p in INSTANTIATION_PATHS.get(e["instantiation"], ())
                     if not (p in FORWARD_ONLY_PATHS and "bwd" in kernel)]
            e["on_main_path"] = bool(paths)
        else:
            instantiated = {p for paths_of in INSTANTIATION_PATHS.values() for p in paths_of}
            paths = [p for p in counts if p not in instantiated]
        by_path = {p: counts[p][kernel] for p in paths}
        e["launches"], e["launches_by_path"] = sum(by_path.values()), by_path
        if kernel in routes["serve"]:
            e["launches_by_route"] = {r: sum(routes[p][kernel][r] for p in paths)
                                      for r in ("wgmma", "mma_sync")}
        if paths:
            require(e["launches"] > 0, f"{e['name']}: no launch on the main paths")
        e["max_err"], e["kernel_ms"] = e["max_abs_err"], e["ms"]  # the phase-3 lines' names

    # What the traced phases and the chaos kills showed, and their walls.
    log("observability", **OBSERVABILITY, walls_s=walls, previous_walls_s=PREVIOUS_WALLS_S,
        settled=SETTLED,
        trace_ids=OBSERVABILITY["profiler"]["trace_ids"],
        chaos_events={"trainer": OBSERVABILITY["trainer"]["chaos_events"],
                      "ring": OBSERVABILITY["ring"]["latency_window"]["events"]},
        overhead_pct=OBSERVABILITY["serve_llm"]["bench_phase1"]["overhead_pct"])
    shutil.rmtree(TRACE_ROOT, ignore_errors=True)

    log("summary", train_tokens_per_s=train["tokens_per_s"],
        moe_serve_prefill_tokens_per_s=moe_serve["prefill_tokens_per_s"],
        moe_train_tokens_per_s=moe_train["tokens_per_s"],
        sharded_train_tokens_per_s=sharded["tokens_per_s"],
        sharded_train_step_tokens_per_s=sharded["train_step_tokens_per_s"],
        trainer_step_ms=trainer["step_ms"], trainer_restart_s=trainer["restart_s"],
        sp_ring_fwd_bwd_ms=sp["model"]["ring_fwd_bwd_ms"],
        sp_whole_fwd_bwd_ms=sp["model"]["whole_fwd_bwd_ms"],
        pipeline_tokens_per_s=pipe["tokens_per_s"],
        pipeline_fused_tokens_per_s=pipe["fused_tokens_per_s"],
        pipeline_bubble_share=pipe["pp_bubble_share"], bubble_fraction=pipe["bubble_fraction"],
        ep_tokens_per_s=ep["ep_tokens_per_s"], ep_one_rank_tokens_per_s=ep["one_rank_tokens_per_s"],
        lora_tokens_per_s=lora["tokens_per_s"], lora_peak_gib=lora["peak_gib"],
        cnn_img_per_s=cnn["cnn"]["img_per_s"], resnet_img_per_s=cnn["resnet"]["img_per_s"],
        ppo_atari_update_ms=rl["ppo_atari"]["update_ms"],
        ppo_cartpole_update_ms=rl["ppo_cartpole"]["update_ms"],
        **{f"{name}_update_ms": rl2[name]["update_ms"] for name in OFFPOLICY_CASES},
        profiler_capture_overhead_ms=prof["in_process"]["capture_overhead_ms"],
        profiler_trace_bytes=prof["in_process"]["trace_bytes"],
        profiler_seconds=prof["seconds"], http_qps=http["qps"], http_p50_ms=http["p50_ms"],
        http_p99_ms=http["p99_ms"], http_replicas=http["replicas_reached"],
        http_sse_tokens_per_s=http["sse_tokens_per_s"],
        tune_asha_wall_s=tuned["config3"]["wall_s"],
        tune_asha_best_acc=tuned["config3"]["best_acc"],
        tune_trainer_img_per_s=[t["img_per_s"] for t in tuned["trainers"]["trials"]],
        tune_seconds=tuned["seconds"], fmnist_img_per_s=elastic["config1"]["img_per_s"],
        fmnist_card_img_per_s=elastic["config1"]["card_img_per_s"],
        elastic_step_down_wait_s=down["step_down_wait_s"],
        elastic_restart_s=down["restart_s"], churn_wall_ratio=elastic["churn"]["wall_ratio"],
        elastic_seconds=elastic["seconds"], data_rows_per_s=data["plane"]["rows_per_s"],
        data_shuffle_s=data["plane"]["shuffle_s"], data_pool_start_s=data["plane"]["pool_start_s"],
        data_fmnist_img_per_s=data["config1"]["img_per_s"],
        data_ingest_share=data["config1"]["ingest_share"], data_seconds=data["seconds"],
        mux_qps=mux["qps"], mux_hit_p99_ms=mux["hit_p99_ms"], mux_miss_p99_ms=mux["miss_p99_ms"],
        mux_evictions=sum(r["evictions"] for r in mux["replicas"].values()),
        chaos_lost=chaos["lost"], chaos_p99_ratio=chaos["p99_ratio"],
        chaos_hedges_launched=chaos["hedges_launched"], chaos_recover_s=chaos["recover_s"],
        dag_pipelined_tokens_per_s=pipe28["pipelined_tokens_per_s"],
        dag_sequential_tokens_per_s=pipe28["sequential_tokens_per_s"],
        dag_driver_tokens_per_s=pipe28["driver_tokens_per_s"],
        dag_host_hop_overhead_pct=dagr["hop"]["host"]["hop_overhead_pct"],
        dag_cuda_hop_overhead_pct=dagr["hop"]["cuda"]["hop_overhead_pct"],
        dag_actor_calls_per_step=dagr["rpc"]["dag_actor_calls_per_step"],
        dag_recovery_latency_s=dagr["recovery"]["recovery_latency_s"],
        dag_seconds=dagr["seconds"],
        ring_exact_tokens_per_s=ring["runs"]["exact"]["tokens_per_s"],
        ring_int8_tokens_per_s=ring["runs"]["int8"]["tokens_per_s"],
        ring_fp8_tokens_per_s=ring["runs"]["fp8"]["tokens_per_s"],
        ring_int8_wire_ratio=ring["runs"]["int8"]["wire_ratio"],
        ring_codec_int8_encode_ms=ring["codec"]["int8"]["encode_ms"],
        ring_overlap_hidden=ring["overlap_bench"]["on"]["hidden"],
        ring_seconds=ring["seconds"], llm_qps=llm_run["qps"], llm_lost=llm_run["lost"],
        llm_p99_ratio=llm_run["p99_ratio"],
        llm_decode_controller_rpcs=llm_run["decode_controller_rpcs"],
        llm_pools_scale_independent=llm_run["pools_scale_independent"],
        llm_seconds=llm_run["phase_seconds"],
        runtime_call_ms=model31["call_ms"], runtime_forward_ms=model31["forward_ms"],
        runtime_d2h_ms=model31["d2h_ms"], runtime_h2d_ms=model31["h2d_ms"],
        runtime_put_gb_per_s={k: v["gb_per_s"] for k, v in runtime["objects"].items()
                              if k != "sums"},
        runtime_tasks_per_s=runtime["microbenchmark"]["async_tasks_per_s"],
        runtime_actor_calls_per_s=runtime["microbenchmark"]["async_actor_calls_per_s"],
        runtime_restart_s=runtime["faults"]["restart_s"], runtime_seconds=runtime["seconds"],
        seconds=time.perf_counter() - _t_start)
    require_no_reference("chip_smoke")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
