"""Chip smoke test for the PyTorch + CUDA port (``mmlspark_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — a CUDA card must be present; prints its name and power limit
   (``nvidia-smi``) and turns TF32 off for matmuls and cuDNN;
2. build — compiles every ``csrc/*.cu`` with nvcc for sm_90a, one nvcc
   per source, all started together, and the native binning loop
   (``native/fastpath.cpp``) with g++ beside them;
3. kernels — each kernel (K1 on bf16 pages, K2 on int8 and fp8 pages, at
   a decode tick, serving's own decode over its 64-page block table, a
   2047-key straggler, a chunked-prefill extend at full width and
   serving's own window shapes: a prompt's first and second chunks, an
   8-token prefix suffix at an unaligned position, four rows with one
   inactive, speculative verify windows of 3 and 9 queries over the
   decode tick's 16 rows, two inactive, a 512-token chunk; K1 also at
   phase 13b's own verify windows, 2 and 3 queries of its 8-head target
   over 16 rows at its request lengths, two inactive; K3 on bf16 and K4
   on int8 and fp8 pages at 16 rows of 4 queries, at W = 1, 5, 16 and
   64, serving's decode lengths over its 64-page table and the
   straggler) against its plain PyTorch version on
   the card: context within about one bf16 ulp (plus 2^-8 of the same
   attention over |V| for the tensor-core window body, K1/K2 at W > 1,
   which rounds P to bf16), pages and scales bitwise, the read-only
   sweep's pools untouched and its length-0 rows exactly 0, inactive
   rows untouched, NaN planted past every bound kept out; each call on
   the body the library reports (K1/K2 split at W = 1, tensor-core at
   W > 1; K3/K4 split at every W, groups of ``mmlspark_pa_read_group``
   queries a block), one kernel launch a call and no memset
   (``torch.profiler``); then its time, the plain version's time, one
   PyTorch library call's time as a yardstick, and the least time the
   card could take (its bound);
4. parity — at full width in float32, the engine's greedy tokens through
   the kernel equal those through the plain gather path, token for token,
   on f32 pages and on int8 and fp8 pages, the kernel engine's decode
   steps on the split body;
5. serving — a bf16 ``GenerationEngine`` at full width answers a dozen
   HTTP ``POST /generate`` requests (chunked prompts, a shared prefix, an
   SSE stream); K1 must have launched in this run, its launches split by
   the body the library reports into extends on the tensor-core body
   (prefill chunks and prefix suffixes, each once per layer, from the
   engine's chunk trace and prefix hits) and decode steps on the split
   body (the engine's other attention calls, once per layer), no other;
6. quantized serving — a bf16 ``ContinuousDecoder(kv_dtype="int8")`` at
   full width serves the same request mix through ``submit``/``step``
   (then a shorter fp8 run); K2 must have launched and K1 not, split by
   body as in 5, with the pool at 66/128 of the bf16 layout's bytes per
   position;
7. read-only sweep — the public ``paged_attention`` over bf16 and int8
   pools the model filled, every layer: K3, then K4, each launch on the
   split body (W = 4);
8. GBDT — (a) the histogram kernel K6 against its plain version at the
   level shapes of an 11M x 28 run (1 ... 16 nodes), at 64 and 80
   nodes, at 256 nodes on ragged rows, on uint16 bins, bf16-rounded
   stats, bagged-out rows, a 2-bin feature and HIGGS's four 3-valued
   b-tag columns at 16 nodes, and class-batched levels (one launch for
   7 classes at Covertype's 581,012 x 54 and 1, 4 and 16 nodes; 3
   classes on uint16 bins): counts bitwise, g/h within 2e-6 *
   sum|stat| + 1e-7 of a float64 sum; times beside the plain version,
   one ``index_add_`` and the bound (the class-batched cases also
   beside K single-class launches), each case's launch plan; rows K6
   must drop and fractional count weights on every body; and the
   shared-memory atomics the library compiled to; (b) one full-size
   tree (depth 5) through K6 and
   through the plain version: the same splits, or a recorded tie; (c)
   the native binning loop against the numpy loop on 1,000,000 rows of
   the repo's HIGGS-shaped matrix (bins bitwise, seconds each), then
   ``train()`` on all 11,000,000 x 28 of it, 100 iterations after a
   1-iteration warm-up: exactly 5 K6 launches per iteration and no plain
   call, every bin from the native loop, train AUC above 0.75, a bitwise
   model string round trip; bin, upload and boosting seconds, sec/iter
   and K6's share of an iteration;
9. flash attention — (a) K7 (with and without stats), K8a and K8b
   against their plain versions at BERT-base (B=8, H=12, S=512, D=64,
   ragged padding masks with one fully padded row, NaN planted in every
   masked key row), the causal decoder (B=2, S=2048), an unaligned S=200
   at D=32 and D=128, the main paths' own shapes, and masks with a whole
   64-key hole in every row (the masked-tile skip) at D=64 and D=128,
   each in bf16 and f32: f32 within 1e-5 * max|ref|, bf16 within 2 bf16
   ulps (+ 1e-5 * max|ref|) of the plain f32 result, plus 2^-8 of the
   same product over absolute values for the bf16 K7's o, K8a's dK and
   dV and K8b's dQ (they round P and dS to bf16 once); the fully padded row
   exactly 0; times at the ``FLASH_TIMED`` shapes beside the plain
   versions, SDPA (forward and its autograd backward) and the bounds;
   (b) BERT-base f32 ``transformer_apply(use_flash=True)`` and
   the gradients of ``loss_fn`` through the kernels against the same
   through the plain versions, and dense against flash on the rows that
   are not fully padded; (c) bf16 encoder inference at B=32, S=512:
   sequences/s with exactly 12 K7 launches per forward, and the
   hidden states against one forward through dense attention; (d) bf16
   training at B=16, S=512: 10 ``train_step``s after a warm-up, 12
   launches each of K7, K8a and K8b per step, the loss lower at the
   end, step seconds and tokens/s; then one step of the causal decoder
   at B=4, S=2048 with flash and with dense attention: flash's peak
   device memory below dense's;
10. the mesh — (a) K5a (bf16 pages) and K5b (int8, fp8) against their
   plain versions at the decode (split body) and extend (tensor-core
   body) shapes, the decode on 6 heads (one rank's shard at tp = 2),
   serving's own decode (16 rows up to 448 keys over a 64-page block
   table) and a straggler (one row at 2047, the rest at 64 or below):
   ctx within about one bf16 ulp (plus 2^-8 of the same attention over
   |V| at the extend), NaN planted at and past pos kept out, every pool
   bit untouched, the body the library reports, one kernel launch a
   call (``torch.profiler``); times beside the plain versions, SDPA and
   the bounds, the wrapper's host-paced time and host issue cost, and
   the rows the mesh path writes after the kernel timed alone; (b) a tp
   = 1 mesh (a world of one rank over NCCL): f32 full-width greedy
   tokens of the meshed kernel engine equal phase 4's single-device ones
   and the meshed gather engine's, on f32, int8 and fp8 pages, through
   K5a/K5b (decode steps on the split body) and never K1/K2; (c) bf16
   serving of phase 6's mix on a single-device engine and on the tp = 1
   mesh: K1 (single device) or K5a (mesh) once per layer per attention
   call, the tensor-core launches exactly the prefill chunks and prefix
   suffixes times the layers and the split ones the decode steps,
   tokens/s and p50 tick side by side;
   (d) tp = 2 as two gloo processes sharing the card, six heads and a
   pool shard each: both ranks' f32 tokens equal each other's and 10b's
   over all 16 tokens, the decode steps on the split body.
11. batched ONNX inference — ResNet-50 from ``export_resnet_onnx(RESNET50,
   seed=0)`` through ``DataFrame`` → ``ONNXModel.transform`` (no hand
   kernel on this path): (a) float32 logits of 32 uint8 NHWC rows from
   the card's ONNX path, from ``resnet_apply`` on the card with the same
   params and (4 rows) from the ONNX path on the CPU, within 1e-3 of the
   largest |logit|, argmax identical; (b) bench.py's headline
   configuration (2048 rows in an object column, batch 512, bf16,
   transpose + ImageNet normalization + argmax on the card): warm-up
   over the buckets the run hits, 3 timed passes, images/s (median),
   the stage seconds (coerce, pad, h2d, dispatch, d2h), the batch
   function and the graph alone on a resident batch of 512 (device ms
   by CUDA events beside host issue ms; the graph channels-last and
   contiguous NCHW), FLOPs an image from the graph's Conv and Gemm
   shapes and the share of the bf16 peak, and the bf16 logits within
   2^-4 of the largest f32 |logit| of (a), argmax equal wherever f32's
   top-two gap exceeds that; (c) the same rows as a resident column
   with ``output_device=True``: images/s, zero h2d bytes, outputs
   bitwise (b)'s.

12. GBDT estimators — (a) the north-star configuration through
   ``LightGBMClassifier(device=None).fit`` on a ``DataFrame`` (the
   HIGGS-shaped matrix as a 2-D ``features`` column, 8c's params): time
   to model, 5 K6 launches an iteration, no plain call, every bin
   native; the booster against 8c's ``train()`` (same trees' splits;
   AUC within 1e-4 and probabilities within 1e-4 on average, since K6's
   atomic order keeps two runs from being bitwise equal); ``transform``
   of the first 1,000,000 rows, the probability column bitwise
   ``Booster.predict``, train AUC above 0.75; (b) 7-class
   ``objective="multiclass"`` at Covertype's shape (a seeded matrix,
   labels the argmax of a sparse seeded linear map plus noise), 10% of
   the rows in the validation column: 5 K6 launches an iteration (one
   a level for all classes), no plain call, the first iteration's 7
   trees through K6 and the plain version the same (or a recorded tie),
   training multi-logloss below ln 7 / 2, probability rows summing to 1
   within 1e-6, a bitwise model string round trip; sec/iter and K6's
   share.

13. speculative serving — (a) f32 full width, phase 4's engine and
   prompts with a draft of bench.py's widths (d_model 128, 4 heads, 2
   layers, d_ff 512) at FULL's vocabulary, gamma = 3: the greedy tokens
   equal phase 4's kernel tokens on f32, int8 and fp8 pages, and K1/K2
   launch on the FMA window body exactly (verify windows + prefill
   chunks + prefix suffixes) x layers times, the verify windows counted
   where the engine runs them (k a dispatch); the target as its own draft
   (gamma = 4) gives the same tokens at acceptance above 0.95; (b)
   bench.py's generation configuration (bench.py:480-557: a bf16 8-layer
   d_model 512 target over vocabulary 8192 and its 2-layer draft, 16
   slots, gamma = 2, ``autotune=True``), its warm-up and 48-request mix:
   tokens/s, step p50/p99/max, prefix pages shared, tokens per round
   and slot, the autotuner's history, K1 launches all on the tensor-core
   body and equal to (verify windows + chunks + prefix suffixes) x
   layers; then the same mix through the plain engine in the same
   process (tokens/s, p50, the share of requests with identical greedy
   tokens, reported, not asserted: bf16 verify windows round P to bf16;
   for each request where they part, the f32 logit gap between the two
   engines' picks at the first differing token).

14. transformer ONNX graphs through the converter — (a) BERT-base at its
   published widths (``init_bert_params(BertOnnxConfig(vocab=30522,
   layers=12, d_model=768, heads=12, d_ff=3072, max_len=512), seed=0)``)
   as the ORT-optimized graph ``fused_bert_onnx`` writes (contrib
   ``EmbedLayerNormalization``, ``Attention``, ``SkipLayerNormalization``,
   ``BiasGelu``) and as ``export_bert_onnx``'s decomposed graph, through
   ``DataFrame`` → ``ONNXModel(device=None).transform`` in float32 on 256
   right-padded rows of 512 ids (lengths 32 ... 512, batches of 32):
   exactly 12 K7 launches a batch for the fused graph (``_attention_core``
   on K7, no dense call on the card, no plain call), none for the
   decomposed one, the fused graph on the CPU for 4 rows; all hidden
   states within 1e-3 of the largest |hidden| of one another; (b) both
   graphs in bfloat16 (warm-up over the dynamic sequence axis, one untimed
   pass, 3 timed passes): sequences/s side by side, 12 K7 launches a
   batch, the fused states within 2^-4 of (a)'s largest |hidden|, each
   graph's batch function on a resident batch (device ms by CUDA events,
   host issue ms); K7 alone
   at the call's shape (B=32, H=12, S=512, D=64, the first batch's mask)
   beside its plain version, SDPA with the mask and its bound, and the
   contiguous copies of the split-off heads; (c) one-node graphs on the
   card, each one K7 launch, against the CPU path within 1e-3 of the
   largest |output| (f32): com.microsoft ``Attention`` with
   ``unidirectional=1``, ``MultiHeadAttention``, ai.onnx ``Attention``
   causal, ``GroupQueryAttention`` prefill (B=4, S=512, 32 q heads over 8
   kv heads, hd 128, rotary); then a ``GroupQueryAttention`` decode step
   over a static cache on the dense path, no K7 launch, its caches bitwise
   the CPU's; (d) ViT-B/16's logits (``export_vit_onnx``, 8 rows) and
   FULL's decoder (``export_decoder_onnx``, 8 decode steps of 2 rows) on
   the card against the CPU, within 1e-3 of the largest |logit|.

15. durable sessions, prefill-ahead and the async front — (a)
   ``scripts/bench_decode.py``'s continuous-batching row at FULL's widths
   in bf16 (``DECODE_CB``: 32 slots, ``max_len`` 257, 16 steps a
   dispatch, depth 2, ``prefill_ahead=32``; a 32-request warm-up of 2 new
   tokens, then 64 seeded 128-token prompts of 128 new tokens): tokens/s,
   ``staged_prefills`` (above 0), TTFT p50 and max, K1 launches split by
   body against the engine's decode calls (no extend: staged prompts
   prefill densely); the same mix with ``prefill_ahead=0`` in the same
   process beside it and the share of identical requests; before that, at
   f32, phase 4's engine with ``prefill_ahead=4`` and nine of its prompts
   for four slots gives phase 4's tokens with the stage used; (b)
   bench.py's failover phase (``bench.py:695-758``: 2 slots, 8-token
   pages, an 8-token prompt, 16 new tokens, checkpoint after 6 steps) at
   FULL's widths on f32, bf16, int8 and fp8 pages: the blob's bytes are
   the pool's pages and scales, the adopted pages are the blob's, the
   warm restore prefills nothing and gives the uninterrupted tokens at
   every dtype, the cold one at f32 (elsewhere its share and the f32
   logit gap where it parts), a journal-only recovery at f32 gives them
   too; ``emitted_at_checkpoint``, ``blob_bytes``, ``cold_restore_ms``,
   ``warm_adopt_ms``, ``warm_reprefills``, and K1/K2 launches on the
   restored engines by body; (c) ``GenerationEngine(transport="async",
   prefill_ahead=...)``: at f32 phase 4's prompts over one keep-alive
   connection give phase 4's tokens; at bf16 phase 5's mix and one
   ``Expect: 100-continue`` request on phase 5's engine at 8 slots
   (``prefill_ahead=8``) all answer 200 (K1 by body as in 5),
   and ``/metrics`` carries the engine's, the server's, the admission
   queue's and the journal's counters.
16. the observability plane and the model registry on the serving
   fronts — (a) ``GenerationEngine`` with ``gen@1`` live in the
   registry, every request carrying its own ``traceparent``, one of two
   tenants and ``X-Mmlspark-Model: gen``: at f32 phase 4's prompts, three
   times each, give phase 4's tokens; at bf16 phase 5's engine and mix all
   answer 200 with their trace ids echoed under the server's span, each
   ``/debug/traces/{id}`` holds its root span and (a chunked prompt's)
   ``prefill_chunk`` events, ``/debug/slo`` has one window per tenant
   counting its requests, ``/debug/costs`` bills ``device_seconds`` and
   ``kv_page_seconds`` to each tenant's class, ``/debug/timeseries`` holds
   samples of the engine's live-slot gauge, ``/metrics`` the card's
   memory gauges (above 0, at most its total), ``/healthz`` is ok, and K1
   runs by body as in 5; tokens/s and p50 tick; (b) ``ServingEngine``
   over the ORT-fused BERT-base (``fused_bert_onnx(pooled=True)``, bf16,
   batches of 32, replies the ``cls`` row) with ``bert@1`` live and
   ``bert@2`` (same graph and weights) a 25% canary and 50% shadow, both
   registered through ``register_model``; 14b's 256 rows, one request
   each, all parked before the engine starts (so drains take full
   batches): ``bert@2`` serves exactly the requests the ``_bucket`` split
   sends it, shadow pairs and replies agree with a direct
   ``ONNXModel.transform`` within 14b's bf16 bound (2^-4 of the largest
   |cls|), K7 runs 12 launches a dispatched batch, and ``POST /models``
   promoting ``bert@2`` retires ``bert@1`` (``drained``) and frees at
   least 90% of its parameter bytes on the card; sequences/s; (c)
   ``/debug/profile?seconds=2`` during a second 16a burst: the Chrome
   trace it writes names K1's kernels and the engine's
   ``continuous.prefill`` range, and a second capture request meanwhile
   gets 409. ``time_front.py`` times 16a's front alone in 20 s
   closed-loop bursts, for comparing trees in one call.
17. BASELINE's image configurations on phase 11's ResNet-50 (no hand
   kernel on this path: the resize is ``F.interpolate``, convs cuDNN) —
   (a) #4, transfer learning: 2048 seeded uint8 BGR images, 256 × 256
   and 240 × 320 rows alternating, through ``ImageFeaturizer``
   (``cut_output_layers=1``, ImageNet normalization, bf16, batches of
   512: per shape one counted ingest of the raw bytes, then the resize,
   the channel swap and the normalization on the card, the runner
   moving no bytes); first, in f32 on 32 rows, the logits of
   ``cut_output_layers=0`` within 1e-5 of the largest |logit| of
   ``ONNXModel.transform`` on the same rows prepped by hand, and the
   features within 1e-3 of the largest |feature| of the port's CPU run;
   then an untimed pass and 3 timed ones: images/s (median), the
   featurizer's and the runner's stage seconds, the bf16 features within
   2^-4 of the largest f32 |feature|; then ``LogisticRegression
   (max_iter=200)`` on the 2048-wide features, standardized, with 10
   labels from a seeded linear rule on them: fit seconds and train
   accuracy above 0.9; (b) #5: ``ImageLIME`` and ``ImageSHAP``
   (256 samples, 16-pixel cells: up to 196 superpixels) over 8 of (a)'s
   images resized to 224, explaining the bf16 featurizer's logit of the
   first image's top class: 2048 masked images each through the runner
   in 4 batches of 512; each row's all-on sample scores the unmasked
   image within 2^-4 of the largest |logit|, SHAP's Σφ = f(x) within
   1e-6 of Σ|φ|, the card's SLIC labels (distances on the card) equal
   the CPU's and its masked samples ``mask_image``'s bitwise, the solves
   replayed from the explainer's draws equal its own bitwise and the
   CPU's on the same scores (LIME within 1e-3 of the largest |coef|,
   SHAP within 1e-2 of |f(x) − base|); seconds per explained image,
   model rows/s, and the share of SLIC and the masks against the
   model's.

18. the quantized ONNX path and the converter's long tail (no hand kernel
   but K7 inside 18b's BERT) — (a) ResNet-50 (phase 11's export) in
   onnxruntime's QOperator layout (``qoperator_resnet_onnx``: a
   ``QuantizeLinear`` on the input, 53 ``QLinearConv``s with per-channel
   int8 weights, the stem ``MaxPool`` in float between a
   ``DequantizeLinear`` and a ``QuantizeLinear``, ``QLinearAdd`` skip
   joins, ``QLinearGlobalAveragePool``, ``QGemm``), calibrated by min/max
   on 4 of phase 11's rows on the CPU, through ``ONNXModel(device=None,
   compute_dtype="float32").transform``: every ``QLinearConv`` output code
   of 8 rows bitwise the port's CPU run, the logits within 1e-6 of the
   largest |logit| of the CPU's, argmax equal to phase 11a's f32 float
   graph on at least 90% of 32 rows; phase 11b's 2048 rows host-fed in
   batches of 512 (one untimed and 3 timed passes): images/s beside the
   float graph's in bf16 (11b's configuration) in the same run, and one
   batch's device ms by CUDA events (the integer sums exact in float64:
   cuDNN convolutions, a cuBLAS DGEMM); (b) 14b's fused BERT-base with
   ``quantize="int8"`` in bf16 on its 256 rows beside the same graph
   unquantized: 12 K7 launches a batch, hidden states within 2^-4 of the
   largest unquantized |hidden|, the packed tensors at most 0.5 + 2 /
   rows of their bf16 bytes (one byte a value and a float32 scale a
   column), their bytes on the card (``torch.cuda.memory_allocated``
   around each parameter cache, built first) within the allocator's
   rounding of that, sequences/s of both; (c) ``onnx_op_cases``:
   one-node graphs of every control-flow, recurrent, resampling,
   detection and long-tail handler (Loop, Scan, LSTM, GRU at T = 64) on
   the card against the CPU, integer outputs and moved data bitwise,
   floats within 1e-5 of the largest |output| + 1e-6.
19. a GBDT model after ``fit`` (no hand kernel but K6 in the fits) —
   (a) BASELINE #2 past ``fit``: the first 2,750,000 rows of 8c's
   HIGGS-shaped 11,000,000 x 28 (all of them until phase 27 joined the
   script, to keep it within its time limit) as a
   2-D ``features`` column with 8c's params through ``device=None``
   estimators: model A (50 iterations); B, 50 more from
   ``model_string=A``: 100 trees, the first 50 bitwise A's, exactly 250
   K6 launches and no plain call, its first new tree at A's scores through
   K6 and the plain version the same (or a recorded tie), train AUC(B) >=
   AUC(A); C, 50 iterations from ``init_score_col`` = A's raw margins:
   ``base_score`` 0, 250 launches, its first tree against B's 51st (or a
   recorded tie) and how many of the 50 agree; ``features_shap_col`` on B
   over 65,536 rows (additive within 1e-5 * (1 + |margin|) on every row,
   the first 1,024 within 1e-6 * max|phi| of the port's CPU TreeSHAP;
   seconds, rows/s, the launches of the call);
   ``B.to_onnx()`` through ``ONNXModel(device=None, compute_dtype="float32", mini_batch_size=
   65536)`` over 1,000,000 rows (probabilities within 1e-5 of B's, labels
   equal where |p - 0.5| > 1e-5, h2d bytes only the padded features;
   rows/s beside ``B.transform``'s); ``B.booster.refit`` on rows
   1,750,000 - 2,749,999 (structures bitwise, seconds; a 100,000-row
   refit on the card within 1e-5 * max|leaf| of the CPU's);
   ``trees_to_dataframe`` (6,300 rows, bitwise B's arrays); (b) a 7-class
   model at 12b's shape, 20 iterations (SHAP on 8,192 rows, additive per
   class; the SOFTMAX export through ``ONNXModel`` within 1e-5, rows
   summing to 1 within 1e-6; a 5-iteration (n, 7) ``init_score`` fit, 5
   K6 launches an iteration) and a ``LightGBMRegressor`` on 1,000,000
   HIGGS rows, 20 iterations (``TreeEnsembleRegressor`` through
   ``ONNXModel`` within 1e-5 * (1 + |y|) of its ``transform``); (c)
   ``ml_op_cases``: the other 14 ai.onnx.ml-family handlers, one node
   each, on the card against the CPU (integers bitwise, floats within
   1e-5 * max|ref| + 1e-6).
20. full-sequence generation on bench.py's generation pair (the target
   8 x 512, vocab 8192, head dim 64; the draft 2 x 128), no new kernel —
   (a) ``distill.train_lm`` of the bf16 target with ``use_flash`` on 60
   ``markov_sampler`` batches of 32 x 128 (a language over its first 256
   ids), then ``distill_draft`` of the draft from it, 60 steps: the LM
   loss falls and the KL falls below half its start, every step's
   attention on K7 forward and K8a / K8b backward (8 of each a target
   step; 8 K7 of the frozen teacher and 2 of each for the draft a
   distillation step), no plain call; seconds a step; (b) the trained
   target with the distilled and with a random draft, f32 and bf16,
   gamma 4, 4 prompts of 16 tokens, 64 new:
   ``generate_speculative_paged(paged_attn="kernel")`` (K1 on every
   verify window, rounds x 8 launches, FMA body in f32, tensor-core body
   in bf16), ``generate_speculative`` and ``generate_cached``; in f32
   every speculative id equals ``generate_cached``'s, in bf16 the share
   that agrees; tokens/s, acceptance and target forwards per token of
   each; (c) ``generate_beam`` (W = 4, 16 new, without and with an eos
   from the first run's best hypothesis) of the f32 target: ids equal
   the CPU's, scores within 1e-5 x max|score|; (d) sampled ``generate``
   (``use_flash``: 32 x 8 K7 launches) and ``generate_cached`` give the
   same tokens; (e) ORT ``GreedySearch`` / ``BeamSearch`` over a
   two-layer GPT-style decoder subgraph at the target's widths through
   ``ONNXModel``: sequences equal the CPU's; (f) BERT-base exported with
   external data through ``ONNXModel(external_data_dir=)``: outputs
   bitwise the inline graph's; (g) ``extra_op_cases`` (22 of
   ``extra_ops.py``'s handlers) on the card against the CPU, and the
   four ``Random*`` by their law.

21. the rest of the GBDT trainer at full width, K6 on every level (5
   launches an iteration, counted; no plain histogram call on the path)
   — (a) goss, dart and rf on 8c's HIGGS shape (the first 2,750,000 of
   its rows, in (b) and (e) too), 25 iterations each
   beside gbdt (rf with bagging 0.632 every iteration): each mode's
   first tree through K6 has the splits of the same tree through the
   plain histogram in float64 (or a recorded tie, as 8b); goss's and dart's train
   AUC above 0.75 and within 0.05 of gbdt's, goss's root cover its
   selection, dart's leaves no larger than gbdt's, rf's AUC above 0.6
   and no worse than its first tree's, its raw scores within one tree's
   range (< 5), a dart model string round-tripping to bitwise
   predictions;
   sec/iter of each, goss's host selection (d2h and numpy) seconds an
   iteration; (b) monotone constraints (+1 on column 0, -1 on column 1),
   ``path_smooth`` 10 and two overlapping interaction groups on HIGGS,
   25 iterations: predictions monotone along a 64-point sweep of each
   constrained column on 4,096 rows, every root-to-leaf path within one
   group; (c) ``LightGBMClassifier.fit`` on a ``DataFrame`` of benchm-ml's
   airline shape (1,250,000 rows of its 10M, 2,500,000 until phase 27
   joined the script: Month 12, DayofMonth 31, DayOfWeek 7,
   UniqueCarrier 22, Origin 300 and Dest 300 categorical, DepTime and
   Distance numeric; a seeded per-category delay rule) with
   ``categorical_feature`` and without: AUC with it at least AUC
   without; ``transform``'s probabilities on the first 1,000,000 rows
   within 1e-6 of the booster's; time to model, sec/iter, the encoder's
   host seconds; (d) the same rows one-hot encoded, a 1,250,000 x 674
   CSR of 8 non-zeros a row, through ``train()`` with EFB: the plan's
   bundles and bundle bins, host binning and bundling seconds, sec/iter,
   K6 at the bundled shape (uint16, 1 and 16 nodes; ms, bound,
   ``index_add_``'s ms); on the first 250,000 rows the EFB model's
   trees have a dense model's splits, until a tree whose first
   difference is a tie (gains within 1e-4 of the tree's largest,
   ``_model_ties``), their leaves within 2e-3 * max|leaf| (a small
   child's stats come by subtraction from its parent's); (e)
   ``linear_tree`` on HIGGS, 25 iterations: the first tree's leaf
   coefficients through K6 equal those through the plain histogram
   within 1e-5 * max|coef|;
   sec/iter, the seconds in
   ``fit_linear_leaves``; ``shap_values`` and ``to_onnx`` refuse the
   model.

22. the last serial GBDT options and ONNX fine-tuning at full width —
   (a) ``LightGBMRanker.fit`` on a ``DataFrame`` at MSLR-WEB30K's
   published shape (136 features; queries of about 120 documents, the
   largest 1,251, as its Fold1 training split, whose 18,919 queries and
   about 2.26M rows are cut to a quarter of the queries for the time limit;
   labels 0-4 from a seeded rule at MSLR's label shares), 50 iterations,
   K6 on every level (5 launches an iteration): the lambdarank
   gradients on the card (float64, groups bucketed by size) against the
   plain version on 128 queries (256 until phase 27 joined the script),
   the largest among them, within 1e-12
   of max|g| (tied and rounded scores); the first tree through K6 has
   the plain float64 histogram's splits or a recorded tie; the held-out
   fifth of queries' mean NDCG@10 above the first tree's; ``transform``
   gives the raw scores; sec/iter, the gradients' seconds an iteration,
   K6 at this shape (1 and 16 nodes; ms, bound, ``index_add_``'s ms);
   (b) ``extra_trees`` with ``feature_fraction_bynode`` 0.5 on 8c's
   HIGGS shape (its first 2,750,000 rows), 50 iterations beside gbdt: the threefry draws on the
   card bitwise the CPU's, every split's bin the node's drawn candidate
   (below its feature's ``feat_bins``) and its feature in the node's
   drawn subset, the first tree as the plain histogram's, train AUC above
   0.75 and within 0.05 of gbdt's; (c) step checkpoints on HIGGS's first
   1,000,000 rows: 25 iterations with ``checkpoint_interval`` 5, then a
   50-iteration call on the same directory resumes at 25 and saves at
   50, its first 25 trees the checkpoint's, its splits an uninterrupted
   run's up to a recorded tie (``_model_ties``) and its leaves within
   2e-3 * max|leaf|; (d) ``ONNXEstimator.fit`` of the fused BERT-base
   (12 layers, d 768, vocabulary 30522, seeded params) with a CLS
   ``MatMul`` + ``Add`` head and a graph-carried
   ``SoftmaxCrossEntropyLoss``, float32, 2,048 rows of 128 ids (a
   seeded marker-token rule), batch 32, Adam lr 5e-5, one epoch of 64
   steps: the first step's loss and every gradient through K7 / K8a /
   K8b against the decomposed graph (``export_bert_onnx(opset=17)``,
   dense attention) on the card (1e-5 relative; 1e-4 of each tensor's
   max|g|), 12 K7, 12 K8a and 12 K8b launches a step and no dense
   attention, the mean loss of the last 8 steps below the first 8's, the
   fitted ``ONNXModel`` (``weights_override``) serving 256 rows within
   1e-5 of a direct forward and unlike the base graph; seconds a step,
   sequences/s, peak memory; (e) the same with ``lora_rank`` 8, 32
   steps: the base params bitwise unchanged, only the adapters in the
   optimizer, the override the adapted matrices, serving as in (d)
   (its losses recorded, not held).
23. the tuner and the periphery that computed with jax (no hand kernel:
   matmuls, gathers, ``index_add_`` and batched solves on the card) —
   (a) ``VowpalWabbitClassifier`` (logistic, 18 bits, minibatches of 64,
   2 passes) at LIBSVM rcv1.binary's shape (677,399 rows over 47,236
   features, 20-150 non-zeros a row, a planted sparse linear rule; its
   20,242-row split held out): over the first 65,536 rows the card's
   weights within 1e-4 of the largest |weight| of the port's CPU run and
   its held-out AUC within 0.002 of the CPU run's; the whole set's
   held-out AUC at least 0.9; rows/s, ms and
   kernel launches a minibatch step (``torch.profiler``); the featurizer
   over 100,000 raw rows (host seconds), indices bitwise the plain
   murmur3 loop's on 1,000; the contextual bandit on 65,536 events of 4
   arms, its scores on the first 8,192 within 1e-4 of the largest |score|
   of the CPU run's and the best arm found on 90% of events; (b) ``KNN`` at ANN-benchmarks'
   sift-128-euclidean shape (1,000,000 x 128 corpus, 10,000 queries, k
   100, a seeded Gaussian mixture): on 256 queries every returned id
   within 1e-5 (||q||^2 + max ||c||^2) of the true k-th squared distance
   (float64) and recall@100 at least 0.999; queries/s, the query chunk,
   peak memory; (c) ``SAR`` (jaccard, decay 30 days, support 4) at
   MovieLens-1M's shape (6,040 users, 3,706 items, 1,000,209 ratings over
   three years): the item similarity bitwise the CPU's, 100,000 pairs'
   scores within 1e-4 of a float64 product, ``recommend_for_all_users
   (k=10)`` free of seen items; fit and scoring seconds; (d)
   ``AccessAnomaly`` (rank 10, 25 iterations, implicit) on two tenants of
   10,000 users x 2,000 resources and 500,000 accesses clustered by
   department: 10,000 test pairs' scores within 1e-3 (1 + max |score|) of
   the port's CPU run from the same initial factors, seen pairs' mean
   below cross-department pairs'; ALS seconds an iteration, the fit's
   host seconds; (e) ``ONNXModel(tuning="auto")`` on phase 11's ResNet-50
   (bf16, batches of 256 by default) with 2,048 rows as partitions of 37,
   129, 511 and 1,371 over an
   observation store in a temporary directory: the cold store runs
   ``measured_sweep`` within ``probe_budget()`` probes and writes
   observations, a second model on the persisted store decides every
   partition without probing, both within phase 11's bf16 bound (2^-4 of
   the largest |logit|) of the untuned model; images/s of each call,
   recorded, not held. Each sub-phase logs its wall seconds, host share
   (one minus the profiled device-busy share of its main call) and peak
   memory;
24. the AutoML training pipeline (no hand kernel of its own: K6 under
   the learners; sizes in ``P24``): (a) ``TrainClassifier`` on an
   Adult-shaped frame (32,561 rows, UCI Adult's 6 numeric and 8 string
   columns at its level counts, 24.08% ">50K" drawn from a fixed logistic
   function of the columns), once with the default LogisticRegression and
   once with LightGBMClassifier (K6), each scored by
   ``ComputeModelStatistics`` / ``ComputePerInstanceStatistics`` on a
   quarter held out and held to the same code with ``device="cpu"``: the
   logistic AUC within 1e-4 and its predictions equal but where the CPU's
   probability is within 1e-4 of 1/2, LightGBM's AUC within 5e-3 (K6's
   atomics), both above 0.8; (b) ``TuneHyperparameters`` over
   LightGBMClassifier on the first 125,000 rows of phase 8's HIGGS set
   (8 trials over num_leaves, learning_rate, min_data_in_leaf and
   feature_fraction; AUC): full at parallelism 4 and 1 (the same best
   params, best AUCs within 5e-3), halving (num_iterations 4 to 64,
   factor 4) and tpe (4 startup trials), each best AUC above 0.75;
   trials/s, seconds and K6 launches a trial; ``FindBestModel`` over the
   three best models on the tuners' validation rows picks the highest
   AUC, which equals its tuner's; (c) ``TextFeaturizer`` then
   ``TrainClassifier(LogisticRegression)`` on 20,000 generated reviews
   (20-200 tokens over a Zipf vocabulary of 50,000 words, ratings 1-5
   cut at 3): features bitwise the CPU run's on 1,000 rows, AUC within
   1e-4 of the CPU's and above 0.8; the featurizers' host seconds.
25. the HTTP client layer and the web services (host work, and K1 under
   the served model; sizes in ``P25``): (a) HTTP on the port's own
   server: a f32 ``GenerationEngine`` over phase 5's model (16 slots,
   threaded transport) answers 64 rows of phase 5's prompt sizes
   (32/128/384 tokens, 64 new) sent by ``SimpleHTTPTransformer`` (JSON
   in, ``AsyncHTTPClient`` at concurrency 16, JSON out) and 4 more by
   ``SingleThreadedHTTPClient`` (16 until phase 27 joined the script); every row's tokens equal an in-process
   ``ContinuousDecoder``'s with the same settings, no error column is
   set, K1's launches split by body against the engine's attention
   calls; rows/s, client seconds a row (p50, max), the server's requests
   by code; (b) ``SimpleDetectAnomalies``' local median/MAD detector on
   1,000 series x 2,016 points (a week at the Numenta Anomaly
   Benchmark's 5-minute cadence; synthesized, even-length groups) on the
   card, scores bitwise and flags equal to ``device="cpu"``'s; seconds
   of host grouping, device and result dicts; (c) the standard-library
   transport: ``TextSentiment`` over 5,000 rows (10,000 until phase 27
   joined the script) against an in-process
   mock service at concurrency 16 (every answer 200 and as the mock
   means it), then 250 rows (500 until phase 27 joined the script) with
   the mock answering 429 +
   ``Retry-After: 0`` to every other call: every row completes; rows/s.
26. the distributed serving plane (``serving/distributed.py``: a driver
   registry and three ``DistributedWorker``s in one process, a
   ``ServingCluster``; sizes in ``P26``) with the port's decoders behind
   ``adopt_handler`` and ``session_exporter``, phase 4's FULL model:
   (a) warm drain: worker-0's bf16 ``ContinuousDecoder`` (16 slots)
   runs 16 sessions (seeded prompts of 128-448 tokens, 64 new each) for
   24 steps, then ``drain_worker("worker-0")`` checkpoints every live
   session and ships its page blob over ``/_adopt`` to worker-1, whose
   decoder restores each one warm: every session's tokens equal an
   uninterrupted decoder's, the adopter prefills nothing and launches
   only the split decode body, the adopted pages and scales equal the
   blob byte for byte, worker-0 is gone from the routing table; bf16
   pages (K1), then int8 (K2); blob bytes raw and as JSON, the drain's
   seconds, ms an adopted session; (b) cold kill: worker-1's f32
   decoder journals 4 sessions into worker-1's server journal, its
   heartbeats stop without a goodbye, the driver's sweeper (1 s) calls
   the worker dead and the cluster replays the journal onto worker-2's
   decoder over ``/_adopt``, which re-prefills each session: f32 tokens
   equal the uninterrupted decoder's; seconds from the last heartbeat
   to the verdict and to the adoption, re-prefill chunks, launches by
   body; (c) bench.py's scenario phase: ``run_scenario`` of ``smoke``,
   then ``decode-kill``, each against a fresh 3-worker cluster behind
   ``cluster_echo_engine`` (5 ms a batch of 16): the scorecard
   reconciles exactly with the driver's federated ``/debug/cluster``,
   no arrival is lost, ``decode-kill`` loses no session and recovers at
   least one, ``/debug/scenario`` on a worker answers "running" during
   the run; counts, open-loop p50/p99 and fairness error (host numbers).
27. the main path on a dp2 x tp2 mesh — four gloo rank processes sharing
   the card (bench.py:765-860's dp x tp mesh at 4 chips; on a machine
   with four cards the ranks take one each, over NCCL), each computing
   the device rows of its slots of a dp shard for its 6 of 12 heads, the
   page pool replicated over dp (every shard's fresh rows gathered and
   written on each replica); the single-device yardsticks first, in this
   process. (a) FULL in f32 on phase 4's engine (4 slots, 2 a shard):
   every rank's greedy tokens equal phase 4's over ``PARITY_NEW``; FULL
   in bf16, 16 slots (8 a shard), phase 6's mix (64 new): all ranks
   agree on every token and hit the prefix; K5a only, once a layer per
   attention call, the decode steps on the split body and the extends on
   the tensor-core body as the chunk trace and prefix hits say, K1/K2
   never; the two dp replicas of each tp rank hold bitwise-equal pages
   off trash page 0; bench.py's record keys (tokens/s and p50 tick
   beside the single-device engine on the same mix), the dp exchange
   timed alone (host ms of one mount's gather and of a dispatch's join)
   and the exchanges a tick; (b) int8 pages on phase 4's engine: the
   first 4 tokens equal phase 4's int8 ones (bench.py's horizon), K5b
   only, replicas' codes and scales bitwise equal; (c) 13b's target and
   draft at gamma 2: f32 tokens equal the single-device speculative
   engine's over ``PARITY_NEW``, K5a on the FMA body; bf16 on the same
   engine and prompts, the verify windows on K5a's tensor-core body, the
   ranks agree;
   (d) ``GenerationEngine(mesh=)``: 16 HTTP requests to rank 0 (phase
   5's twelve and four more, the prefix owner first), all 200, f32 tokens
   equal the in-process single-device decoder's; then a session
   exported from the tp = 2 pool once it has emitted 4 tokens or more
   (the checkpoint drains the pipeline first; every rank the same
   blob, its pages the ranks' shards concatenated by head, bitwise) is
   adopted warm by a single-device decoder here: 0 re-prefills, its f32
   tokens phase 4's.

``python3 chip_smoke.py 27`` runs phases 1, 2, 4 and 27 only,
``python3 chip_smoke.py 26`` phases 1, 2 and 26,
``python3 chip_smoke.py 25`` phases 1, 2 and 25,
``python3 chip_smoke.py 24`` phases 1, 2 and 24,
``python3 chip_smoke.py 23`` phases 1, 2 and 23,
``python3 chip_smoke.py 22`` phases 1, 2 and 22,
``python3 chip_smoke.py 21`` phases 1, 2 and 21,
``python3 chip_smoke.py 20`` phases 1, 2 and 20,
``python3 chip_smoke.py 19`` phases 1, 2 and 19,
``python3 chip_smoke.py 18`` phases 1, 2 and 18,
``python3 chip_smoke.py 17`` phases 1, 2 and 17,
``python3 chip_smoke.py 16`` phases 1, 2, 4 and 16,
``python3 chip_smoke.py 15`` phases 1, 2, 4 and 15,
``python3 chip_smoke.py 14`` phases 1, 2 and 14,
``python3 chip_smoke.py 13`` phases 1, 2, 4 and 13,
``python3 chip_smoke.py 12`` phases 1, 2, 8c and 12,
``python3 chip_smoke.py 11`` phases 1, 2 and 11,
``python3 chip_smoke.py 10`` phases 1, 2, 4 and 10,
``python3 chip_smoke.py 9`` phases 1, 2 and 9, ``python3 chip_smoke.py
8`` phases 1, 2 and 8, ``python3 chip_smoke.py 7`` phases 1, 2, phase
3's K3/K4 cases and 7, and ``python3 chip_smoke.py 3`` phases 1, 2 and
3; each prints no result and exits 3.

The last three lines are the kernels' JSON record, the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them, and ``{"ok": true, "device":
{...}}``. Nothing here imports JAX or the JAX package.
"""

import functools
import json
import os
import statistics
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

#: data-sheet peaks by card name: (HBM bytes/s, dense bf16 FLOP/s,
#: float32 FLOP/s outside the tensor cores)
PEAKS = [("H200", 4.8e12, 989e12, 67e12),
         ("H100 NVL", 3.9e12, 835e12, 60e12),
         ("H100 PCIe", 2.0e12, 756e12, 51e12),
         ("H100", 3.35e12, 989e12, 67e12)]

# full width: the repo's GPT-2-small-class decoder (scripts/bench_decode.py)
FULL = dict(vocab=32000, layers=12, d_model=768, heads=12, d_ff=3072,
            max_len=2048, causal=True, norm="rmsnorm", position="rope")


def log(msg):
    print(msg, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing runs on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mmlspark_tpu_torch.utils.device import device_info
    smi_name, power = device_info(0)
    if power is None:
        raise RuntimeError("nvidia-smi did not report the power limit")
    smi = f"{smi_name}, {power}"
    name = torch.cuda.get_device_name(0)
    bw, flops, f32 = next(((b, f, f32) for key, b, f, f32 in PEAKS
                           if key in name), PEAKS[-1][1:])
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    log(f"[device] data-sheet peaks used for bounds: {bw / 1e12} TB/s, "
        f"{flops / 1e12} TFLOP/s bf16, {f32 / 1e12} TFLOP/s f32")
    return {"smi": smi, "name": name, "bw": bw, "flops": flops,
            "flops_f32": f32}


def phase_build():
    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex:
        # the native binning loop (g++) builds beside the kernels (nvcc)
        host = ex.submit(native.build)
        secs = cuda_build.build_all()
        host.result()
    log(f"[build] {secs}, native loop {native._target().name} "
        f"(wall {time.perf_counter() - t0:.2f} s)")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"[build] {name}: {line.strip()}")


def _cuda_ms(fns, reps, head_start=True):
    """Mean device ms per call over ``reps`` back-to-back calls between two
    CUDA events, cycling through ``fns`` (one per copy of the inputs, so
    that together they exceed the 50 MB L2 and each call finds its data
    cold, as each layer of the real model does).

    ``head_start``: the stream first spins for longer than the host takes
    to issue all ``reps`` calls, so the events time the device alone; a
    call whose kernels finish faster than the host issues them (SDPA with
    a mask, a few small kernels a call) would otherwise time the host.
    Without it the reading is paced by whichever is slower."""
    import torch
    t0 = time.perf_counter()
    for f in fns[:3]:
        f()
    host_s = (time.perf_counter() - t0) / min(3, len(fns))
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if head_start:
        # 2e9 cycles a second bounds the H100's SM clock from above, so
        # the spin lasts at least 2 x the host's issue time (at most 0.1 s)
        torch.cuda._sleep(int(min(0.1, 2 * host_s * reps) * 2e9))
    a.record()
    for i in range(reps):
        fns[i % len(fns)]()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _host_ms(fns, reps):
    """Mean host ms to issue one call, over ``reps`` calls cycling through
    ``fns`` while the stream spins far longer than the loop takes: no
    call waits for the device, so this is the caller's host cost alone."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))     # >= 50 ms at the H100's top SM clock
    t0 = time.perf_counter()
    for i in range(reps):
        fns[i % len(fns)]()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e3


def _copies(nbytes):
    """How many copies of ``nbytes`` of inputs exceed twice the L2."""
    return int(min(64, max(4, -(-100 * 2 ** 20 // max(1, nbytes)))))


def _bits(t):
    """A tensor's raw bits, for bitwise comparison of any dtype."""
    import torch
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _kv_case_inputs(B, W, pos_list, seed, store, H=12, P=None):
    """Random pools on the card (quantized through ``quantize_kv`` when
    ``store`` is a quantized dtype), a shuffled block table, and garbage
    in every slot at or past each row's bound: NaN values in bf16 pools;
    NaN scales, plus the NaN code 0x7F in fp8 pools, in quantized ones.
    ``H`` heads (12 at full width, 6 for one rank's shard at tp = 2);
    the block table ``P`` pages wide (an engine's max_len / page), or
    just wide enough for the longest row."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.ops.kv_quant import quantize_kv

    dev = torch.device("cuda")
    hd, page = 64, 16
    pos_np = np.array(pos_list, np.int64)
    P = max(P or 0, int(-(-(pos_np.max() + W) // page)))
    N = 1 + B * P
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    kp = torch.randn(N, H, page, hd, generator=g, device=dev).to(bf)
    vp = torch.randn(N, H, page, hd, generator=g, device=dev).to(bf)
    q, kn, vn = (torch.randn(B, H, W, hd, generator=g, device=dev).to(bf)
                 for _ in range(3))
    perm = torch.randperm(B * P, generator=g, device=dev) + 1
    bt = perm.reshape(B, P).to(torch.int32)
    pools = [kp, vp]
    if store is not None:
        (kp, ks), (vp, vs) = quantize_kv(kp, store), quantize_kv(vp, store)
        pools = [kp, vp, ks, vs]
    t_idx = torch.arange(P * page, device=dev)
    for b in range(B):
        dead = t_idx >= int(pos_np[b])
        pages, offs = bt[b, t_idx[dead] // page].long(), t_idx[dead] % page
        if store is None:
            kp[pages, :, offs] = float("nan")
            vp[pages, :, offs] = float("nan")
            continue
        ks[pages, :, offs] = float("nan")
        vs[pages, :, offs] = float("nan")
        if store != torch.int8:
            kp.view(torch.uint8)[pages, :, offs] = 0x7F
            vp.view(torch.uint8)[pages, :, offs] = 0x7F
    return dict(H=H, hd=hd, page=page, P=P, pos_np=pos_np, q=q, kn=kn,
                vn=vn, bt=bt, pools=pools, t_idx=t_idx)


def _check_ctx(what, got, want, r=None):
    """bf16 output: both round one f32 result whose sums are reordered, so
    they may differ by about one bf16 ulp (<= 2**-7 relative). ``r``: the
    tensor-core window body (K1/K2 at W > 1) also rounds each P (or P times
    the V scale) to bf16 once, which may move ctx by 2**-8 * r more, r
    from ``paged_rounding_scale``."""
    import torch
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    atol, rtol = 4e-3, 1e-2
    bad = diff > atol + rtol * want.float().abs() + (
        0.0 if r is None else 2.0 ** -8 * r)
    if not torch.isfinite(got).all() or bad.any():
        extra = "" if r is None else " + 2**-8*R"
        raise AssertionError(f"{what}: ctx off by more than {atol} + "
                             f"{rtol}*|want|{extra} at {int(bad.sum())} "
                             f"elements, or not finite (max_abs_err {err})")
    return err


def _bound(dev_info, nbytes, flops, peak="flops"):
    t_bytes = nbytes / dev_info["bw"] * 1e3
    t_ops = flops / dev_info[peak] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _dequant_kv(pools, bt, key_ok):
    """The library yardstick's inputs: each row's cached K/V gathered and
    dequantized to contiguous bf16, zero past the bound."""
    import torch
    from mmlspark_tpu_torch.ops import paged_attention as pa
    scales = pools[2:] or [None, None]
    return [torch.where(key_ok[:, None, :, None],
                        pa._gather_rows(p, s, bt.long()), 0.0
                        ).to(torch.bfloat16)
            for p, s in zip(pools[:2], scales)]


def _fused_case(dev_info, label, B, W, pos_list, active_list, seed,
                store=None, P=None, H=12):
    """The fused kernel at one shape: K1 over bf16 pages, or K2 over
    quantized pages of ``store`` dtype, over a block table ``P`` pages
    wide (or just wide enough), ``H`` heads. Correctness against the
    plain version (ctx, every page and scale bitwise with NaN planted at
    and past each pos, inactive rows untouched), the body the library
    reports (split at W = 1, tensor-core at W > 1) and one call = one
    kernel on the card; then times. Returns the record for this shape."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    x = _kv_case_inputs(B, W, pos_list, seed, store, H=H, P=P)
    H, hd, page, P = x["H"], x["hd"], x["page"], x["P"]
    q, kn, vn, bt, pools = x["q"], x["kn"], x["vn"], x["bt"], x["pools"]
    pos_np = x["pos_np"]
    quant = store is not None
    what = (f"K2 {str(store).split('.')[-1]} {label}" if quant
            else f"K1 {label}")
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    active = torch.tensor(active_list, device=dev)
    scale = 1.0 / hd ** 0.5
    wlo, whi = pa.write_range(pos, W, page, active)
    plain = [t.clone() for t in pools]
    want = pa.paged_attention_window_plain(q, kn, vn, plain[0], plain[1],
                                           bt, pos, wlo, whi, scale,
                                           *plain[2:])
    # W > 1 runs the tensor-core body: its bound adds 2**-8 * R
    r = pa.paged_rounding_scale(
        q, kn, vn, pools[0], pools[1], bt, pos, scale,
        *((pools[2], pools[3]) if quant else ())) if W > 1 else None
    kern = [t.clone() for t in pools]
    kw = {"k_scale": kern[2], "v_scale": kern[3]} if quant else {}
    b0 = _bodies()
    got = pa.paged_attention_window(q, kn, vn, kern[0], kern[1], bt, pos,
                                    active=active, **kw)[0]
    torch.cuda.synchronize()
    body = _body_ran(b0, _bodies(), quant)
    if body != ("split" if W == 1 else "mma"):
        raise AssertionError(f"{what}: ran the {body} body")
    err = _check_ctx(what, got, want, r)
    # every non-trash page (and scale) bitwise; inactive rows untouched
    if not all(torch.equal(_bits(a[1:]), _bits(b[1:]))
               for a, b in zip(kern, plain)):
        raise AssertionError(f"{what}: pages or scales differ from the "
                             f"plain version")
    for b in range(B):
        if not active_list[b]:
            rows = bt[b].long()
            if not all(torch.equal(_bits(a[rows]), _bits(o[rows]))
                       for a, o in zip(kern, pools)):
                raise AssertionError(f"{what}: inactive row {b} wrote its "
                                     f"pages")
    # one call is one kernel on the card (the split body's workspace is
    # cached: no memset, no second launch); it writes the same rows again
    launches, memsets, device = _kernel_launches(lambda: pa._fused_window(
        q, kn, vn, kern[0], kern[1], bt, pos, wlo, whi, scale, *kern[2:]))
    if launches != 1 or memsets or len(device) > 1:
        raise AssertionError(f"{what}: one call ran {launches} launches "
                             f"and {memsets} memsets / copies; device "
                             f"activity {device}")
    # kernel time: raw back-to-back launches of the C entry point (no
    # wrapper work between them), over enough pool copies to defeat L2
    lib = pa._library()
    n = _copies(sum(t.numel() * t.element_size() for t in pools))
    copies = [[t.clone() for t in kern] for _ in range(n)]
    stream = torch.cuda.current_stream().cuda_stream
    shape = (B, H, W, P, page, scale, stream)
    work = (None, None)
    if W == 1:
        work = tuple(t.data_ptr() for t in pa._split_workspace(
            q.device, B, H, P, page, hd, lib.split_chunk))
    ints = (bt.data_ptr(), pos.data_ptr(), wlo.data_ptr(), whi.data_ptr(),
            got.data_ptr(), *work)
    rc = []

    def launcher(c):
        ptrs = [t.data_ptr() for t in c]
        if quant:
            return lambda: rc.append(lib.mmlspark_pa_window_fused_q(
                1, pa._STORES[store], hd, q.data_ptr(), kn.data_ptr(),
                vn.data_ptr(), *ptrs, *ints, *shape, None))
        return lambda: rc.append(lib.mmlspark_pa_window_fused(
            1, hd, q.data_ptr(), kn.data_ptr(), vn.data_ptr(), *ptrs,
            *ints, *shape, None))
    ms = _cuda_ms([launcher(c) for c in copies], 200)
    if any(rc):
        raise AssertionError(f"{what}: launch returned {set(rc)}")
    plain_ms = _cuda_ms([lambda c=c: pa.paged_attention_window_plain(
        q, kn, vn, c[0], c[1], bt, pos, wlo, whi, scale, *c[2:])
        for c in copies], 20)
    del copies
    # library yardstick: one SDPA call over the gathered (dequantized)
    # contiguous K/V plus the window (the port never calls it)
    L = P * page
    key_ok = x["t_idx"][None] < pos.long()[:, None]
    kc, vc = _dequant_kv(pools, bt, key_ok)
    k_all = torch.cat([kc, kn], 2).contiguous()
    v_all = torch.cat([vc, vn], 2).contiguous()
    causal = torch.tril(torch.ones(W, W, dtype=torch.bool, device=dev))
    mask = torch.cat([key_ok[:, None, None, :].expand(B, 1, W, L),
                      causal[None, None].expand(B, 1, W, W)], -1)
    n = _copies(2 * k_all.numel() * k_all.element_size())
    kvs = [(k_all.clone(), v_all.clone()) for _ in range(n)]
    sdpa = [lambda c=c: F.scaled_dot_product_attention(
        q, c[0], c[1], attn_mask=mask) for c in kvs]
    library_ms = _cuda_ms(sdpa, 200)
    library_host = _cuda_ms(sdpa, 200, head_start=False)
    del kvs, sdpa
    # bound: each input byte read once, each output byte written once —
    # live cached keys (< pos) of every row with their scales,
    # q/k_new/v_new, ctx, and the fresh rows (codes and scales) of the
    # active rows; flops: QK and PV over live keys
    row_bytes = hd + 2 if quant else 2 * hd     # one K or V row of a head
    live = int(pos_np.sum())
    n_active = int(sum(active_list))
    nbytes = (2 * live * H * row_bytes + 3 * B * H * W * hd * 2
              + B * H * W * hd * 2 + 2 * n_active * W * H * row_bytes
              + bt.numel() * 4 + 3 * B * 4)
    flops = sum(4 * H * hd * W * (int(p) + W) for p in pos_np)
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **_bound(dev_info, nbytes, flops), "library_ms": library_ms,
           "library_ms_host_paced": library_host, "body": body,
           "launches_per_call": launches,
           "shape": {"B": B, "H": H, "W": W, "hd": hd, "page": page, "P": P,
                     "max_pos": int(pos_np.max()), "live_keys": live,
                     "pages": str(store or torch.bfloat16).split(".")[-1]}}
    tag = what.split()[0].lower() + " " + " ".join(what.split()[1:])
    log(f"[{tag}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _read_case(dev_info, label, B, W, len_list, seed, store=None, P=None):
    """The read-only sweep at one shape: K3 over bf16 pages, or K4 over
    quantized pages of ``store`` dtype, over a block table ``P`` pages
    wide (or just wide enough). Correctness against the plain version
    (ctx within about one bf16 ulp, the NaN planted past each length kept
    out, rows with ``lengths == 0`` exactly zero, every pool bit
    untouched), the body the library reports (the split body at every W,
    ``mmlspark_pa_read_group(W)`` queries a block) and one call = one
    kernel on the card, no memset; then times. Returns the record for
    this shape."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    x = _kv_case_inputs(B, W, len_list, seed, store, P=P)
    H, hd, page, P = x["H"], x["hd"], x["page"], x["P"]
    q, bt, pools = x["q"], x["bt"], x["pools"]
    quant = store is not None
    what = (f"K4 {str(store).split('.')[-1]} {label}" if quant
            else f"K3 {label}")
    lengths = torch.tensor(len_list, dtype=torch.int32, device=dev)
    scale = 1.0 / hd ** 0.5
    lib = pa._library()
    group = lib.mmlspark_pa_read_group(W)
    if group != (1 if W == 1 else 4):
        raise AssertionError(f"{what}: the library holds {group} queries "
                             f"a block at W = {W}")
    want = pa.paged_attention_plain(q, pools[0], pools[1], bt, lengths,
                                    scale, *pools[2:])
    kern = [t.clone() for t in pools]
    kw = {"k_scale": kern[2], "v_scale": kern[3]} if quant else {}
    b0 = _bodies("read")
    got = pa.paged_attention(q, kern[0], kern[1], bt, lengths, **kw)
    torch.cuda.synchronize()
    body = _body_ran(b0, _bodies("read"), quant)
    if body != "split":
        raise AssertionError(f"{what}: ran the {body} body")
    err = _check_ctx(what, got, want)
    empty = lengths.long() == 0
    if empty.any() and not torch.equal(got[empty].float(),
                                       torch.zeros_like(got[empty]).float()):
        raise AssertionError(f"{what}: a row with lengths == 0 is not zero")
    if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(kern, pools)):
        raise AssertionError(f"{what}: the read-only sweep wrote its pools")
    # one call is one kernel on the card (the split body's workspace is
    # cached: no memset, no second launch)
    launches, memsets, device = _kernel_launches(lambda: pa.paged_attention(
        q, kern[0], kern[1], bt, lengths, **kw))
    if launches != 1 or memsets or len(device) > 1:
        raise AssertionError(f"{what}: one call ran {launches} launches "
                             f"and {memsets} memsets / copies; device "
                             f"activity {device}")
    n = _copies(sum(t.numel() * t.element_size() for t in pools))
    copies = [[t.clone() for t in kern] for _ in range(n)]
    stream = torch.cuda.current_stream().cuda_stream
    work = tuple(t.data_ptr() for t in pa._split_workspace(
        q.device, B, H, P, page, hd, lib.split_chunk, -(-W // group), group))
    tail = (bt.data_ptr(), lengths.data_ptr(), got.data_ptr(), *work, B, H,
            W, P, page, scale, stream, None)
    rc = []

    def launcher(c):
        ptrs = [t.data_ptr() for t in c]
        if quant:
            return lambda: rc.append(lib.mmlspark_pa_read_q(
                1, pa._STORES[store], hd, q.data_ptr(), *ptrs, *tail))
        return lambda: rc.append(lib.mmlspark_pa_read(
            1, hd, q.data_ptr(), *ptrs, *tail))
    ms = _cuda_ms([launcher(c) for c in copies], 200)
    if any(rc):
        raise AssertionError(f"{what}: launch returned {set(rc)}")
    # every launch leaves the arrival counters at 0: a call after the
    # timed ones still merges each (row, head, group) exactly once
    _check_ctx(what + " after the timed launches", pa.paged_attention(
        q, kern[0], kern[1], bt, lengths, **kw), want)
    plain_ms = _cuda_ms([lambda c=c: pa.paged_attention_plain(
        q, c[0], c[1], bt, lengths, scale, *c[2:]) for c in copies], 20)
    del copies
    L = P * page
    key_ok = x["t_idx"][None] < lengths.long()[:, None]
    kc, vc = _dequant_kv(pools, bt, key_ok)
    mask = key_ok[:, None, None, :].expand(B, 1, W, L)
    n = _copies(2 * kc.numel() * kc.element_size())
    kvs = [(kc.clone(), vc.clone()) for _ in range(n)]
    sdpa = [lambda c=c: F.scaled_dot_product_attention(
        q, c[0], c[1], attn_mask=mask) for c in kvs]
    library_ms = _cuda_ms(sdpa, 200)
    library_host = _cuda_ms(sdpa, 200, head_start=False)
    del kvs, sdpa
    # bound: live keys (< lengths, within the table) with their scales,
    # q and ctx; flops QK and PV over the live keys
    row_bytes = hd + 2 if quant else 2 * hd
    live = int(sum(min(n_, L) for n_ in len_list))
    nbytes = (2 * live * H * row_bytes + 2 * B * H * W * hd * 2
              + bt.numel() * 4 + B * 4)
    flops = 4 * H * hd * W * live
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **_bound(dev_info, nbytes, flops), "library_ms": library_ms,
           "library_ms_host_paced": library_host, "body": body,
           "launches_per_call": launches,
           "shape": {"B": B, "H": H, "W": W, "hd": hd, "page": page, "P": P,
                     "max_len": max(len_list), "live_keys": live,
                     "pages": str(store or torch.bfloat16).split(".")[-1]}}
    tag = what.split()[0].lower() + " " + " ".join(what.split()[1:])
    log(f"[{tag}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def read_cases():
    """Phase 3's K3/K4 cases, ``(kernel, label, args, keywords)`` for
    :func:`_read_case` (and ``time_read.py``): K3 on bf16 pages and K4 on
    int8 and fp8 pages, each at "read" (16 rows of 4 queries over the
    decode tick's ragged lengths, row 0 with none), the same lengths at
    W = 1 and W = 5 (a group of 4 and one of 1), serving's decode lengths
    over its engine's 64-page block table at W = 4, the straggler (one
    row at 2047, the rest at 64 or below) at W = 4, and "read" at W = 16
    and W = 64 (many groups re-reading each chunk: the routing's
    evidence)."""
    import torch
    pos, _, serve, straggler = _decode_rows()
    shapes = {"read": ((16, 4, pos), {}),
              "read w1": ((16, 1, pos), {}),
              "read w5": ((16, 5, pos), {}),
              "serving decode w4": ((16, 4, serve), {"P": 64}),
              "straggler w4": ((16, 4, straggler), {}),
              "read w16": ((16, 16, pos), {}),
              "read w64": ((16, 64, pos), {})}
    cases, seed = [], 3
    for store in (None, torch.int8, torch.float8_e4m3fn):
        name = "" if store is None else str(store).split(".")[-1] + " "
        for label, (args, kw) in shapes.items():
            cases.append(("K3" if store is None else "K4", name + label,
                          (label, *args, seed), {"store": store, **kw}))
            seed += 1
    return cases


def phase_read_kernels(dev_info):
    """Phase 3's read-only sweep: every case of :func:`read_cases`."""
    recs = {"K3": {}, "K4": {}}
    for kernel, name, args, kw in read_cases():
        recs[kernel][name] = _read_case(dev_info, *args, **kw)
    return recs


def _decode_rows():
    """The decode ticks of phase 3 and 10a, 16 rows each with rows 5 and
    11 inactive: ``pos``, contexts up to 1023 crossing page and chunk
    boundaries (incl. 0, exact multiples of 16); serving's own decode
    (``serve``, up to 10c's 448 keys); a straggler (one row at 2047, the
    rest at 64 or below: continuous batching with one long context).
    Returns (pos, active, serve, straggler)."""
    import numpy as np
    rng = np.random.default_rng(0)
    pos = [0, 1, 15, 16, 17, 255, 256, 300, 511, 512, 700, 1000, 1023,
           int(rng.integers(1, 1024)), 64, 900]
    active = [True] * 16
    active[5] = active[11] = False
    serve = [int(p) for p in rng.integers(0, 449, 16)]
    straggler = [2047, 0, 64] + [int(p) for p in rng.integers(1, 65, 13)]
    return pos, active, serve, straggler


def phase_kernels(dev_info):
    import numpy as np
    import torch
    pos, active, serve, straggler = _decode_rows()
    recs = {"K1": {}, "K2": {}}
    # the decode tick (the split body): B=16, W=1; serving's decode over
    # its engine's 64-page block table; the straggler. Chunked-prefill
    # extend: one row, a 256-token window at position 384; then serving's
    # own window shapes: a 384-token prompt's first chunk (no cached key)
    # and its second, a prefix-suffix window of the smallest bucket at an
    # unaligned position (a page straddled, half of an m16 query tile
    # empty), and four rows, one inactive (writes nothing); the
    # speculative verify windows (W = gamma + 1: 3 at bench.py's gamma 2,
    # 9 at the autotuner's ceiling 8) over the decode tick's 16 rows, two
    # inactive; a 512-token chunk (the autotuner doubles the chunk budget)
    shapes = {"decode": ((16, 1, pos, active, 1), {}),
              "serving decode": ((16, 1, serve, active, 12), {"P": 64}),
              "straggler": ((16, 1, straggler, active, 13), {}),
              "extend": ((1, 256, [384], [True], 2), {}),
              "chunk1": ((1, 256, [0], [True], 8), {}),
              "chunk2": ((1, 128, [256], [True], 9), {}),
              "suffix8": ((1, 8, [90], [True], 10), {}),
              "extend b4": ((4, 128, [384, 0, 90, 256],
                             [True, True, False, True], 11), {}),
              "verify w3": ((16, 3, pos, active, 14), {}),
              "verify w9": ((16, 9, pos, active, 15), {}),
              "chunk512": ((1, 512, [256], [True], 16), {})}
    for label, (args, kw) in shapes.items():
        recs["K1"][label] = _fused_case(dev_info, label, *args, **kw)
    # phase 13b's own verify windows (K1 only: its pages are bf16): its
    # 8-head target at the gammas it runs (2 at the start, 1 after the
    # autotuner's first step down), 16 rows at its request lengths (a
    # 24, 96, 100 or 384-token prompt plus up to 64 tokens), two
    # inactive, over its block table of (1024 + 8 + 1) / 16 pages
    rng = np.random.default_rng(2)
    spec_pos = [int(rng.choice((24, 96, 100, 384)) + rng.integers(0, 65))
                for _ in range(16)]
    for label, W, seed in (("13b verify w2", 2, 17),
                           ("13b verify w3", 3, 18)):
        recs["K1"][label] = _fused_case(dev_info, label, 16, W, spec_pos,
                                        active, seed, P=65, H=8)
    for store in (torch.int8, torch.float8_e4m3fn):
        name = str(store).split(".")[-1]
        for label, (args, kw) in shapes.items():
            recs["K2"][f"{name} {label}"] = _fused_case(
                dev_info, label, *args, store=store, **kw)
    recs.update(phase_read_kernels(dev_info))
    return recs


def _full_cfg(torch_dtype):
    from mmlspark_tpu_torch.models.zoo.transformer import TransformerConfig
    return TransformerConfig(dtype=torch_dtype, **FULL)


#: phases 4 and 10b: the f32 parity engine and its prompts
PARITY = dict(max_slots=4, max_len=384, page_size=16, prefill_chunk=128,
              steps_per_dispatch=2)
PARITY_PROMPTS = (20, 70, 300)
PARITY_NEW = 16


def _parity_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n) for n in PARITY_PROMPTS]


def _parity_tokens(params_np, cfg, impl, kv_dtype, mesh=None):
    """One f32 parity engine's greedy tokens for the parity prompts, and
    its decode steps: its attention calls less its prefill chunks and
    prefix suffixes."""
    import torch
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    eng = ContinuousDecoder(params_np, cfg, paged_attn=impl,
                            kv_dtype=kv_dtype, mesh=mesh, **PARITY)
    reqs = [eng.submit(p, PARITY_NEW) for p in _parity_prompts(cfg.vocab)]
    for _ in range(400):
        if all(r.done for r in reqs):
            break
        eng.step()
    eng.flush()
    out = [eng.result(r, timeout=1) for r in reqs]
    steps = (eng._kv.stats[f"attn_ticks_{impl}"] - len(eng._chunk_trace)
             - eng.stats["prefix_hits"])
    del eng
    torch.cuda.empty_cache()
    return out, steps


def phase_parity(params_np):
    """f32 full width: kernel and plain-gather engines give the same greedy
    tokens, on model-dtype pages (K1) and on int8 and fp8 pages (K2), the
    kernel engine's decode steps on the split body (one launch per layer
    each) and nothing on the tensor-core body (f32 queries). Returns the
    kernel engine's tokens per page type (10b's reference)."""
    import torch
    cfg = _full_cfg(torch.float32)
    single = {}
    for kv_dtype in (None, "int8", "fp8"):
        outs = {}
        for impl in ("kernel", "gather"):
            _zero_pa_counts()
            outs[impl], steps = _parity_tokens(params_np, cfg, impl, kv_dtype)
            if impl == "kernel":
                bodies, kernel_steps = _bodies(), steps
        name = kv_dtype or "f32"
        if outs["kernel"] != outs["gather"]:
            raise AssertionError(
                f"f32 greedy tokens differ ({name} pages): "
                f"kernel {outs['kernel']} vs gather {outs['gather']}")
        split = bodies["split"] + bodies["q_split"]
        if bodies["mma"] or bodies["q_mma"] or \
                split != kernel_steps * cfg.layers:
            raise AssertionError(f"parity {name} pages: bodies {bodies}, "
                                 f"want {kernel_steps} decode steps x "
                                 f"{cfg.layers} layers on the split body")
        single[kv_dtype] = outs["kernel"]
        log(f"[parity] f32 full width, {name} pages: kernel == gather for "
            f"{len(PARITY_PROMPTS)} requests x {PARITY_NEW} tokens (prompts "
            f"{'/'.join(map(str, PARITY_PROMPTS))}); {split} decode launches "
            f"on the split body")
    return single


def _post(url, payload, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _serving_payloads(vocab, max_new=64):
    """Phase 5's request mix (15c sends it too): nine prompts of 32, 128
    and 384 tokens, two sharing a 96-token prefix (index 9 the owner),
    one SSE stream."""
    import numpy as np
    rng = np.random.default_rng(2)
    shared = [int(t) for t in rng.integers(0, vocab, 96)]
    payloads = []
    for n in [32, 128, 384] * 3:
        payloads.append({"tokens": [int(t) for t in
                                    rng.integers(0, vocab, n)],
                         "max_new": max_new})
    for tail in (8, 24):
        payloads.append({"tokens": shared + [int(t) for t in
                                             rng.integers(0, vocab, tail)],
                         "max_new": max_new, "prefix_key": "system",
                         "prefix_len": len(shared)})
    payloads.append({"tokens": [int(t) for t in rng.integers(0, vocab, 48)],
                     "max_new": max_new, "stream": True})
    return payloads


def phase_serving(params_np, dev_info):
    import torch
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    from mmlspark_tpu_torch.serving.generation import GenerationEngine
    cfg = _full_cfg(torch.bfloat16)
    max_new = 64
    payloads = _serving_payloads(cfg.vocab, max_new)
    eng = GenerationEngine(params_np, cfg, max_slots=16, max_len=1024,
                           page_size=16, prefill_chunk=256,
                           steps_per_dispatch=4)
    results = {}
    try:
        eng.start()
        # warm-up request (cuBLAS handles, allocator), not part of the run
        st, _ = _post(eng.address, {"tokens": [1, 2, 3], "max_new": 4})
        assert st == 200
        eng.decoder.tick_seconds.clear()
        stats0 = dict(eng.decoder._kv.stats)
        chunks0 = len(eng.decoder._chunk_trace)
        hits0 = eng.decoder.stats["prefix_hits"]
        _zero_pa_counts()

        def client(i, p):
            try:
                results[i] = _post(eng.address, p)
            except Exception as e:      # recorded, checked below
                results[i] = (None, repr(e).encode())

        # the prefix owner goes first so its pages are registered
        t0 = time.perf_counter()
        first = threading.Thread(target=client, args=(9, payloads[9]))
        first.start()
        first.join(timeout=300)
        threads = [threading.Thread(target=client, args=(i, p))
                   for i, p in enumerate(payloads) if i != 9]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        # every request is answered: the engine launches nothing more
        launches, bodies = paged_attention_window.launches, _bodies()
        stats = dict(eng.decoder._kv.stats)
        ticks = list(eng.decoder.tick_seconds)
        prefix_hits = eng.decoder.stats["prefix_hits"] - hits0
        chunks = len(eng.decoder._chunk_trace) - chunks0
    finally:
        eng.stop()
    calls = stats["attn_ticks_kernel"] - stats0["attn_ticks_kernel"]
    n_tok = 0
    for i, p in enumerate(payloads):
        status, body = results.get(i, (None, b"missing"))
        if status != 200:
            raise AssertionError(f"request {i} answered {status}: {body!r}")
        if p.get("stream"):
            events = [json.loads(line[6:]) for line in
                      body.decode().split("\n\n") if line.startswith("data: ")]
            final = events[-1]
            if not final.get("done"):
                raise AssertionError(f"stream ended without done: {final}")
            toks = final["tokens"]
            streamed = [t for e in events[:-1] for t in e.get("tokens", [])]
            if streamed != toks:
                raise AssertionError("streamed tokens differ from the final "
                                     "event")
        else:
            toks = json.loads(body)["tokens"]
        if len(toks) != max_new or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"request {i}: {len(toks)} tokens, want "
                                 f"{max_new} in-vocab")
        n_tok += len(toks)
    gather = stats["gather_bytes"] - stats0["gather_bytes"]
    if launches <= 0 or gather != 0:
        raise AssertionError(f"K1 launches {launches}, gather_bytes {gather}")
    if prefix_hits < 1:
        raise AssertionError("the shared-prefix request did not hit")
    split = _window_split("K1", launches, bodies, calls, chunks,
                          prefix_hits, cfg.layers)
    p50 = statistics.median(ticks) * 1e3 if ticks else float("nan")
    rec = {"requests": len(payloads), "tokens": n_tok, "wall_s": wall,
           "tok_per_s": n_tok / wall, "p50_tick_ms": p50,
           "ticks": len(ticks), "k1_launches": launches,
           "k1_launches_decode": split["decode"],
           "k1_launches_extend": split["extend"],
           "decode_steps": split["decode_steps"],
           "prefill_chunks": chunks, "gather_bytes": gather,
           "prefix_hits": prefix_hits, "steps_per_dispatch": 4,
           "layers": cfg.layers}
    log(f"[serving] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _window_split(what, launches, bodies, calls, chunks, hits, layers):
    """A bf16 run's K1, K2 or K5a launches split by the body the library
    reported (``bodies``, :func:`_bodies`' record of the run): the
    extends (W > 1) on the tensor-core body, the decode steps (W = 1) on
    the split body, nothing on the FMA body. Cross-check against the
    engine: its ``calls`` attention calls are every prefill chunk and
    prefix-suffix window of its chunk trace and prefix hits (one extend
    per layer each) and its decode steps (the rest, one split launch per
    layer each)."""
    mma = bodies["mma"] + bodies["q_mma"]
    split = bodies["split"] + bodies["q_split"]
    extend, steps = (chunks + hits) * layers, calls - chunks - hits
    if not 0 < mma < launches or mma != extend or \
            split != steps * layers or mma + split != launches:
        raise AssertionError(f"{what}: {launches} launches, {mma} on the "
                             f"tensor-core body and {split} on the split "
                             f"body; want {extend} from {chunks} chunks and "
                             f"{hits} prefix hits and {steps * layers} from "
                             f"{steps} decode steps, x {layers} layers")
    return {"decode": split, "extend": mma, "decode_steps": steps}


def phase_quant_serving(params_np, dev_info, kv_dtype, sizes):
    """bf16 full width, quantized pages: a ``ContinuousDecoder`` driven by
    ``submit`` and ``step()`` until every request is done (prompts of
    ``sizes`` plus two sharing a 96-token prefix, the prefix owner first,
    64 new tokens each). K2 must be the only paged kernel launched in the
    run, nothing gathered, the prefix hit, the pool at 66/128 of bf16's
    bytes per position, and the write-time probe must have fired."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.ops.kv_quant import kv_bytes_per_position
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    cfg = _full_cfg(torch.bfloat16)
    rng = np.random.default_rng(3)
    max_new = 64
    shared = rng.integers(0, cfg.vocab, 96)
    # quant_probe=2: a run of this mix inserts prefill rows only a few
    # times (one batched insert per pad bucket, one for the prefix owner;
    # chunked prompts and prefix hits insert none), so a larger interval
    # would never fire within it
    eng = ContinuousDecoder(params_np, cfg, max_slots=16, max_len=1024,
                            page_size=16, prefill_chunk=256,
                            steps_per_dispatch=4, kv_dtype=kv_dtype,
                            quant_probe=2)
    warm = eng.submit([1, 2, 3], 4)     # cuBLAS handles, allocator
    while not warm.done:
        eng.step()
    eng.tick_seconds.clear()
    stats0 = dict(eng._kv.stats)
    hits0 = eng.stats["prefix_hits"]
    chunks0 = len(eng._chunk_trace)
    eng._quant_inserts = 0
    _zero_pa_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(np.concatenate([shared, rng.integers(0, cfg.vocab,
                                                            tail)]),
                       max_new, prefix_key="system", prefix_len=len(shared))
            for tail in (8, 24)]
    reqs += [eng.submit(rng.integers(0, cfg.vocab, n), max_new)
             for n in sizes]
    while not all(r.done for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = paged_attention_window.launches, paged_attention_window.launches_q
    bodies = _bodies()
    stats = eng._kv.stats
    for r in reqs:
        toks = eng.result(r, timeout=1)
        if len(toks) != max_new or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"{kv_dtype} request {r.rid}: {len(toks)} "
                                 f"tokens, want {max_new} in-vocab")
    gather = stats["gather_bytes"] - stats0["gather_bytes"]
    hits = eng.stats["prefix_hits"] - hits0
    probes = stats["quant_error_probes"] - stats0["quant_error_probes"]
    hd = cfg.d_model // cfg.heads
    bf16_bpp = cfg.layers * kv_bytes_per_position(cfg.heads, hd,
                                                  torch.bfloat16, False)
    bpp = eng._kv.bytes_per_position()
    if k2 <= 0 or k1 != 0 or gather != 0:
        raise AssertionError(f"{kv_dtype}: K2 launches {k2}, K1 launches "
                             f"{k1}, gather_bytes {gather}")
    if hits < 1:
        raise AssertionError(f"{kv_dtype}: the shared-prefix request did "
                             f"not hit")
    if bpp * 128 != bf16_bpp * 66:
        raise AssertionError(f"{kv_dtype}: {bpp} bytes per position, want "
                             f"66/128 of bf16's {bf16_bpp}")
    if probes < 1:
        raise AssertionError(f"{kv_dtype}: the quantization probe never "
                             f"fired")
    n_tok = sum(len(r.tokens) for r in reqs)
    ticks = list(eng.tick_seconds)
    chunks = len(eng._chunk_trace) - chunks0
    calls = stats["attn_ticks_kernel"] - stats0["attn_ticks_kernel"]
    split = _window_split(f"K2 {kv_dtype}", k2, bodies, calls, chunks, hits,
                          cfg.layers)
    rec = {"kv_dtype": kv_dtype, "requests": len(reqs), "tokens": n_tok,
           "wall_s": wall, "tok_per_s": n_tok / wall,
           "p50_tick_ms": statistics.median(ticks) * 1e3,
           "ticks": len(ticks), "k2_launches": k2,
           "k2_launches_decode": split["decode"],
           "k2_launches_extend": split["extend"],
           "decode_steps": split["decode_steps"],
           "prefill_chunks": chunks, "k1_launches": k1,
           "gather_bytes": gather, "prefix_hits": hits,
           "bytes_per_position": bpp, "bytes_per_position_bf16": bf16_bpp,
           "pool_device_bytes": eng._kv.device_bytes(),
           "quant_error_probes": probes,
           "quant_error_max": stats["quant_error_max"],
           "steps_per_dispatch": 4, "layers": cfg.layers}
    log(f"[quant serving] {json.dumps(rec)} | {dev_info['smi']}")
    del eng
    torch.cuda.empty_cache()
    return rec


def phase_read_sweep(params_np, dev_info):
    """bf16 full width: the public read-only op over pools the model
    filled. Four prompts are prefilled and scattered into a bf16 pool and
    an int8 pool; ``paged_attention`` then runs every layer's queries
    over each (K3, then K4), held against a dense softmax over the
    gathered keys, with a row of length 0 giving zeros. Every launch
    must be on the split body, which the dispatch names at every W."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.zoo import transformer as tf
    from mmlspark_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain)
    from mmlspark_tpu_torch.utils.device import resolve_device
    cfg = _full_cfg(torch.bfloat16)
    dev = resolve_device()
    params = tf.params_from_numpy(params_np, cfg, dev)
    rng = np.random.default_rng(4)
    B, W, page, L = 4, 4, 16, 512
    fill = [37, 200, 1, 511]
    lengths = torch.tensor([37, 200, 0, 511], dtype=torch.int32, device=dev)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab, (B, L))).to(dev)
    _, rows = tf.prefill_cache(params, ids, torch.tensor(fill, device=dev),
                               cfg, L)
    P = L // page
    bt = (1 + torch.randperm(B * P, device=dev)).reshape(B, P).to(torch.int32)
    hd = cfg.d_model // cfg.heads
    q = torch.randn(cfg.layers, B, cfg.heads, W, hd, device=dev).to(
        torch.bfloat16)
    key_ok = (torch.arange(L, device=dev)[None]
              < lengths.long()[:, None])[:, None, None, :]
    counts = {}
    err = 0.0
    for kv_dtype in (None, "int8"):
        pages = tf.paged_scatter_rows(
            tf.init_paged_cache(cfg, 1 + B * P, page, dev, kv_dtype), rows,
            bt, page)
        gathered = tf.paged_gather(pages, bt, L, out_dtype=torch.float32)
        for name in ("", "_q", "_split", "_q_split"):
            setattr(paged_attention, "launches" + name, 0)
        outs = []
        for li, c in enumerate(pages):
            scales = ({"k_scale": c["k_scale"], "v_scale": c["v_scale"]}
                      if kv_dtype else {})
            outs.append(paged_attention(q[li], c["k"], c["v"], bt, lengths,
                                        **scales))
        torch.cuda.synchronize()
        counts[kv_dtype or "bf16"] = _bodies("read") | {
            "k3": paged_attention.launches, "k4": paged_attention.launches_q}
        # a length past the table reads the whole table, as the plain
        # version does (row 3's table is L keys; 511 of them filled)
        past = lengths.clone()
        past[3] = L + 89
        c = pages[0]
        scales = ((c["k_scale"], c["v_scale"]) if kv_dtype else ())
        _check_ctx(f"read sweep {kv_dtype} past the table",
                   paged_attention(q[0], c["k"], c["v"], bt, past,
                                   **dict(zip(("k_scale", "v_scale"),
                                              scales))),
                   paged_attention_plain(q[0], c["k"], c["v"], bt, past,
                                         hd ** -0.5, *scales))
        for li, (out, g) in enumerate(zip(outs, gathered)):
            s = (q[li].float() @ g["k"].transpose(-1, -2)) / hd ** 0.5
            s = torch.where(key_ok, s, -1e30)
            p = torch.softmax(s, -1) * key_ok
            want = p @ g["v"]
            if out.shape != q[li].shape:
                raise AssertionError(f"read sweep: ctx {tuple(out.shape)}")
            err = max(err, _check_ctx(f"read sweep {kv_dtype} layer {li}",
                                      out, want))
            if out[2].abs().max().item() != 0.0:
                raise AssertionError("read sweep: the length-0 row is not "
                                     "zero")
    n = cfg.layers
    want = {"bf16": {"k3": n, "k4": 0, "split": n, "q_split": 0},
            "int8": {"k3": 0, "k4": n, "split": 0, "q_split": n}}
    if counts != want:
        raise AssertionError(f"read sweep launches {counts}, want {want} "
                             f"on the split body")
    k3, k4 = counts["bf16"]["k3"], counts["int8"]["k4"]
    rec = {"rows": B, "queries": W, "lengths": lengths.tolist(),
           "layers": cfg.layers, "k3_launches": k3, "k4_launches": k4,
           "body": "split", "k3_launches_split": counts["bf16"]["split"],
           "k4_launches_split": counts["int8"]["q_split"],
           "max_abs_err_vs_dense": err}
    log(f"[read sweep] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


#: phase 13: bench.py's generation engine and mix (bench.py:517-557); its
#: target and draft widths are tick_profile's ``SPEC`` and ``SPEC_DRAFT``
SPEC_ENGINE = dict(max_slots=16, max_len=1024, page_size=16,
                   prefill_chunk=256, autotune=True)
SPEC_MIX = dict(lens=(24, 96, 384), requests=48, max_new=64)


def _spec_cfgs(torch_dtype, vocab=None):
    """bench.py's generation target and draft configs (tick_profile's
    widths, causal) in ``torch_dtype``, the draft at ``vocab`` if given."""
    from mmlspark_tpu_torch.models.zoo.transformer import TransformerConfig
    from mmlspark_tpu_torch.serving.tick_profile import SPEC, SPEC_DRAFT
    d = dict(SPEC_DRAFT, vocab=vocab or SPEC_DRAFT["vocab"])
    return (TransformerConfig(dtype=torch_dtype, causal=True, **SPEC),
            TransformerConfig(dtype=torch_dtype, causal=True, **d))


def _spec_windows(eng):
    """(verify windows, prefill chunks, prefix hits) of an engine's run,
    each counted where it ran. Every dispatch ran k verify windows, and
    these three are all of the engine's attention calls."""
    windows = eng.stats.get("spec_verify_windows", 0)
    chunks, hits = len(eng._chunk_trace), eng.stats["prefix_hits"]
    ticks, calls = len(eng.tick_seconds), eng._kv.stats["attn_ticks_kernel"]
    if ticks >= eng.tick_seconds.maxlen or windows != ticks * eng._k or \
            calls != windows + chunks + hits:
        raise AssertionError(
            f"{windows} verify windows in {ticks} dispatches of k = "
            f"{eng._k}; {calls} attention calls against {chunks} chunks + "
            f"{hits} prefix suffixes + the windows")
    return windows, chunks, hits


def _spec_parity_run(params_np, cfg, d_np, d_cfg, kv_dtype, gamma):
    """13a: one f32 parity engine with a draft; its greedy tokens, the
    launches by body and the acceptance counters."""
    import torch
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    _zero_pa_counts()
    eng = ContinuousDecoder(params_np, cfg, kv_dtype=kv_dtype,
                            draft_params=d_np, draft_cfg=d_cfg, gamma=gamma,
                            **PARITY)
    reqs = [eng.submit(p, PARITY_NEW) for p in _parity_prompts(cfg.vocab)]
    for _ in range(400):
        if all(r.done for r in reqs):
            break
        eng.step()
    eng.flush()
    out = [eng.result(r, timeout=1) for r in reqs]
    windows, chunks, hits = _spec_windows(eng)
    b = _bodies()
    # f32 windows run the FMA body: the launches no other body reported
    fma = (paged_attention_window.launches + paged_attention_window.launches_q
           - sum(b.values()))
    if b["mma"] + b["q_mma"] + b["split"] + b["q_split"] or \
            fma != (windows + chunks + hits) * cfg.layers:
        raise AssertionError(
            f"13a {kv_dtype or 'f32'} pages: bodies {b}, {fma} FMA "
            f"launches; want ({windows} verify windows + {chunks} chunks + "
            f"{hits} prefix suffixes) x {cfg.layers} layers on the FMA "
            f"body")
    rec = {"gamma": gamma, "verify_windows": windows, "chunks": chunks,
           "launches_fma": fma, "launches_spec_verify": windows * cfg.layers,
           "spec_emitted": eng.stats["spec_emitted"],
           "spec_round_slots": eng.stats["spec_round_slots"]}
    del eng
    torch.cuda.empty_cache()
    return out, rec


def phase_spec_parity(params_np, single):
    """13a: f32 full width, phase 4's engine and prompts with a draft of
    bench.py's widths at FULL's vocabulary (seed 1) at gamma = 3: the
    greedy tokens equal phase 4's kernel tokens on f32, int8 and fp8
    pages, every verify window on the FMA body (K1, or K2). Then the
    target as its own draft at gamma = 4 (the 15 tokens after the first
    fill three whole rounds of 5, so full acceptance reads 1.0): the same
    tokens, acceptance above 0.95."""
    import torch
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    cfg = _full_cfg(torch.float32)
    d_cfg = _spec_cfgs(torch.float32, cfg.vocab)[1]
    d_np = init_transformer(d_cfg, 1)
    recs = {}
    for kv_dtype in (None, "int8", "fp8"):
        name = kv_dtype or "f32"
        out, rec = _spec_parity_run(params_np, cfg, d_np, d_cfg, kv_dtype, 3)
        if out != single[kv_dtype]:
            raise AssertionError(f"13a {name} pages: spec tokens {out} vs "
                                 f"phase 4's {single[kv_dtype]}")
        recs[name] = rec
        log(f"[spec parity] f32 full width, {name} pages, gamma 3: tokens "
            f"== phase 4's; {json.dumps(rec)}")
    out, rec = _spec_parity_run(params_np, cfg, params_np, cfg, None, 4)
    acc = (rec["spec_emitted"] / rec["spec_round_slots"] - 1.0) / 4
    rec["acceptance"] = acc
    if out != single[None] or not acc > 0.95:
        raise AssertionError(f"13a perfect draft: acceptance {acc}, tokens "
                             f"{out} vs phase 4's {single[None]}")
    recs["perfect_draft"] = rec
    log(f"[spec parity] the target as its own draft, gamma 4: tokens == "
        f"phase 4's, acceptance {acc}; {json.dumps(rec)}")
    return recs


def _bench_generation(eng, vocab):
    """bench.py's generation mix (bench.py:525-577) through ``eng``:
    warm-up requests (one per prompt length, a prefix pair), then 48
    requests (every third in the shared-prefix cohort, every sixth of the
    rest chunked), 64 new tokens each, one ``step()`` at a time. Returns
    (record, the timed requests' tokens, their prompts)."""
    import numpy as np
    import torch
    lens, n_reqs, max_new = (SPEC_MIX["lens"], SPEC_MIX["requests"],
                             SPEC_MIX["max_new"])
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(1, vocab, lens[1], dtype=np.int32)

    def drain():
        while any(r is not None for r in eng._slot_req) or eng._waiting:
            eng.step()

    for n in lens:
        eng.submit(rng.integers(1, vocab, n, dtype=np.int32), 4)
    eng.submit(sys_prompt, 4, prefix_key="bench-sys")
    eng.submit(np.concatenate([sys_prompt, rng.integers(
        1, vocab, 4, dtype=np.int32)]), 4, prefix_key="bench-sys")
    drain()
    share0 = eng._kv.stats["prefix_share_hits"]
    reqs, prompts = [], []
    for i in range(n_reqs):
        if i % 3 == 2:
            ids = np.concatenate([sys_prompt, rng.integers(
                1, vocab, 4, dtype=np.int32)])
            reqs.append(eng.submit(ids, max_new, prefix_key="bench-sys"))
        else:
            n = lens[i % 2] if i % 6 else lens[2]
            ids = rng.integers(1, vocab, n, dtype=np.int32)
            reqs.append(eng.submit(ids, max_new))
        prompts.append(ids)
    steps = []
    t0 = time.perf_counter()
    while any(r is not None for r in eng._slot_req) or eng._waiting:
        s0 = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - s0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = [eng.result(r, timeout=1) for r in reqs]
    if any(len(t) != max_new or not all(0 <= x < vocab for x in t)
           for t in toks):
        raise AssertionError("13b: a request came back short or out of "
                             "the vocabulary")
    lat = np.sort(np.asarray(steps)) * 1e3
    n_tok = sum(len(t) for t in toks)
    rec = {"tok_per_s": n_tok / wall, "tokens": n_tok, "wall_s": wall,
           "steps": len(steps), "step_p50_ms": float(lat[len(lat) // 2]),
           "step_p99_ms": float(lat[min(len(lat) - 1,
                                        int(len(lat) * 0.99))]),
           "step_max_ms": float(lat[-1]),
           "prefix_share_hits": eng._kv.stats["prefix_share_hits"] - share0,
           "max_chunk_window": max(eng._chunk_trace, default=0),
           "kv_pages": eng._kv.num_pages}
    return rec, toks, prompts


def _divergence_gaps(params_np, cfg, prompts, spec_toks, plain_toks):
    """Where the spec and plain engines' greedy tokens part: for each such
    request, the target's f32 logits (its bf16 weights widened to f32, one
    dense prefill) after the tokens both emitted, at the two engines'
    picks. A near tie shows as a gap between the picks far below the
    logits' spread."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.zoo.transformer import (params_from_numpy,
                                                           prefill_cache)
    cfg32 = cfg._replace(dtype=torch.float32)

    def widen(p):
        if isinstance(p, dict):
            return {k: widen(v) for k, v in p.items()}
        if isinstance(p, list):
            return [widen(v) for v in p]
        return p.float()

    params = widen(params_from_numpy(params_np, cfg))
    dev = params["lm_head"]["w"].device
    out = []
    for i, (ids, a, b) in enumerate(zip(prompts, spec_toks, plain_toks)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([ids, np.asarray(a[:j], ids.dtype)])
        with torch.no_grad():
            lg, _ = prefill_cache(
                params, torch.as_tensor(seq[None], device=dev),
                torch.tensor([seq.size], device=dev), cfg32,
                max_len=seq.size)
        lg = lg[0]
        top2 = torch.topk(lg, 2).values
        out.append({"request": i, "token": j, "spec": a[j], "plain": b[j],
                    "f32_argmax": int(lg.argmax()),
                    "gap": float(lg[a[j]] - lg[b[j]]),
                    "top2_gap": float(top2[0] - top2[1]),
                    "spread": float(lg.std())})
    del params
    torch.cuda.empty_cache()
    return out


def phase_spec_bench(dev_info):
    """13b: bench.py's generation configuration on the card: the bf16
    target and draft (seeds 0 and 1), 16 slots, gamma = 2, autotune, its
    warm-up and 48-request mix; then the same mix through the plain
    engine (no draft, the same other settings) in the same process. K1
    launches only on the tensor-core body: (verify windows + prefill
    chunks + prefix suffixes) x layers."""
    import torch
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    cfg, d_cfg = _spec_cfgs(torch.bfloat16)
    params_np = init_transformer(cfg, 0)
    d_np = init_transformer(d_cfg, 1)
    _zero_pa_counts()
    eng = ContinuousDecoder(params_np, cfg, draft_params=d_np,
                            draft_cfg=d_cfg, gamma=2, **SPEC_ENGINE)
    spec, spec_toks, prompts = _bench_generation(eng, cfg.vocab)
    windows, chunks, hits = _spec_windows(eng)
    b = _bodies()
    k1, k2 = paged_attention_window.launches, paged_attention_window.launches_q
    if k2 or b["split"] or k1 != b["mma"] or \
            k1 != (windows + chunks + hits) * cfg.layers:
        raise AssertionError(
            f"13b: K1 {k1} launches ({b}), K2 {k2}; want ({windows} verify "
            f"windows + {chunks} chunks + {hits} prefix suffixes) x "
            f"{cfg.layers} layers, all on the tensor-core body")
    spec.update({
        "verify_windows": windows, "chunks": chunks, "prefix_hits": hits,
        "k1_launches": k1, "launches_spec_verify": windows * cfg.layers,
        "launches_extend": (chunks + hits) * cfg.layers,
        "spec_emitted": eng.stats["spec_emitted"],
        "spec_round_slots": eng.stats["spec_round_slots"],
        "tokens_per_round_slot": (eng.stats["spec_emitted"]
                                  / eng.stats["spec_round_slots"]),
        "gamma_end": eng._tuner.gamma, "chunk_end": eng._tuner.chunk,
        "depth_end": eng._tuner.depth, "tuner_history": eng._tuner.history})
    del eng
    torch.cuda.empty_cache()
    _zero_pa_counts()
    eng = ContinuousDecoder(params_np, cfg, **SPEC_ENGINE)
    plain, plain_toks, _ = _bench_generation(eng, cfg.vocab)
    plain["tuner_history"] = eng._tuner.history
    del eng
    torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(spec_toks, plain_toks))
    gaps = _divergence_gaps(params_np, cfg, prompts, spec_toks, plain_toks)
    rec = {"spec": spec, "plain": plain,
           "identical_requests": same, "requests": len(spec_toks),
           "identical_share": same / len(spec_toks),
           "divergence_max_abs_gap": max((abs(g["gap"]) for g in gaps),
                                         default=0.0),
           "divergence_max_gap_over_spread": max(
               (abs(g["gap"]) / g["spread"] for g in gaps), default=0.0),
           "divergences": gaps}
    log(f"[spec bench] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


_HIGGS = {}


def make_higgs_like(n, f=28, seed=0):
    """The repo's HIGGS-shaped generator (``scripts/bench_gbdt_higgs.py``):
    53% positives, standard-normal features, a correlated shift on the
    positives. Generated once per (n, f, seed) and handed out as copies:
    phases 8, 19, 21, 22 and 24 use the same 11M rows, ~9 s of host work
    to draw."""
    import numpy as np
    if (n, f, seed) not in _HIGGS:
        rng = np.random.default_rng(seed)
        y = (rng.random(n) < 0.53).astype(np.float64)
        X = rng.normal(0, 1, (n, f)).astype(np.float32)
        shift = (0.3 * rng.normal(1, 0.2, f)).astype(np.float32)
        X[y == 1] += shift
        _HIGGS[(n, f, seed)] = (X, y)
    X, y = _HIGGS[(n, f, seed)]
    return X.copy(), y.copy()


def _auc(y, p):
    import numpy as np
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    pos = y == 1
    n1, n0 = pos.sum(), (~pos).sum()
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def check_hist(what, got, plain, ref, mag):
    """K6 against its plain version: counts bitwise equal to the f32 plain
    version's; g/h within 2e-6 * sum|stat| + 1e-7 of the float64 plain
    version (``ref``; ``mag`` is the same on |g|, |h|): the kernel adds in
    atomic order, the reference sums exactly. Returns (max_abs_err,
    max error over its bound)."""
    import torch
    if got.shape != plain.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or "
                             f"non-finite values")
    if not torch.equal(got[..., 2], plain[..., 2]):
        raise AssertionError(f"{what}: counts differ from the plain version")
    err = (got[..., :2].double() - ref[..., :2]).abs()
    bound = 2e-6 * mag[..., :2] + 1e-7
    if bool((err > bound).any()):
        raise AssertionError(f"{what}: g/h off by more than 2e-6 * "
                             f"sum|stat| + 1e-7 at {int((err > bound).sum())}"
                             f" slots (max_abs_err {err.max().item()})")
    return err.max().item(), (err / bound).max().item()


#: HIGGS's four b-tag columns (jet 1-4), three values each after binning
BTAG_COLUMNS = (8, 12, 16, 20)


def _hist_inputs(n, F, n_nodes, n_bins, seed, bin_dtype=None, bagged=0.0,
                 few_values=()):
    """One level's K6 inputs on the card, from ``seed``: uniform bins and
    node ids, normal g, uniform h, w = 1 (or 0 on a ``bagged`` share of
    the rows, g and h zeroed there). ``few_values``: (columns, values)
    pairs, each column's bins drawn from ``values`` only."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, n_bins, (F, n), generator=gen, device=dev,
                         dtype=torch.int32)
    for cols, values in few_values:
        vals = torch.tensor(values, dtype=torch.int32, device=dev)
        for c in cols:
            bins[c] = vals[torch.randint(0, len(values), (n,), generator=gen,
                                         device=dev)]
    bins = bins.to(bin_dtype or torch.uint8)
    node = torch.randint(0, n_nodes, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    w = torch.ones(n, device=dev)
    if bagged:
        w = (torch.rand(n, generator=gen, device=dev) >= bagged).float()
        g, h = g * w, h * w
    return bins, node, g, h, w


def hist_cases():
    """Phase 8a's cases, (label, n, F, n_nodes, n_bins, seed, options):
    the level shapes of the HIGGS run (1 ... 16 nodes); 64 and 80 nodes
    at the same size (the slots of four or five trees' 16-node levels
    at once: one feature's table fills a block's shared memory at 64
    and takes 3 slot chunks at 80) and 256 nodes on ragged rows (the
    direct body); uint16 bins, bf16-rounded stats,
    bagged-out rows, a 2-bin feature at the root and HIGGS's four
    3-valued b-tag columns at 16 nodes (lanes of a warp on one slot);
    phase 21d's EFB bundles (``bundled_hist_cases``)."""
    import torch
    n, F, ragged = GBDT["rows"], GBDT["features"], GBDT["ragged"]
    cases = [(f"nodes{k}", n, F, k, 255, 10 + i, {})
             for i, k in enumerate((1, 2, 4, 8, 16))]
    return cases + [
        ("nodes64", n, F, 64, 255, 26, {}),
        ("nodes80", n, F, 80, 255, 27, {}),
        ("ragged_nodes256", ragged, F, 256, 255, 20, {}),
        ("uint16_bins1024", ragged, F, 4, 1024, 21,
         {"bin_dtype": torch.int16}),
        ("bf16_stats", n, F, 16, 255, 22, {"stats_dtype": torch.bfloat16}),
        ("bagged10", n, F, 16, 255, 23, {"bagged": 0.1}),
        ("two_bin_feature", n, F, 1, 255, 24,
         {"few_values": (((0,), (1, 2)),)}),
        ("btag_nodes16", n, F, 16, 255, 25,
         {"few_values": ((BTAG_COLUMNS, (0, 1, 2)),)})] + bundled_hist_cases()


def _hist_case(dev_info, label, n, F, n_nodes, n_bins, seed,
               bin_dtype=None, stats_dtype=None, bagged=0.0, few_values=(),
               reps=20):
    """K6 at one level shape against its plain version, then its time, the
    plain version's, one ``index_add_`` over the whole output with
    precomputed flat ids (the library yardstick) and its bound."""
    import torch
    from mmlspark_tpu_torch.ops import histogram as hm

    dev = torch.device("cuda")
    bin_dtype = bin_dtype or torch.uint8
    bins, node, g, h, w = _hist_inputs(n, F, n_nodes, n_bins, seed,
                                       bin_dtype, bagged, few_values)
    args = (bins, node, g, h, w)
    kw = {"stats_dtype": stats_dtype}
    got = hm.level_histogram(*args, n_nodes, n_bins, **kw)
    torch.cuda.synchronize()
    plain = hm.level_histogram_plain(*args, n_nodes, n_bins, **kw)
    gs, hs, ws = (t.to(stats_dtype).float() if stats_dtype else t
                  for t in (g, h, w))
    ref = hm.level_histogram_plain(bins, node, gs.double(), hs.double(),
                                   ws.double(), n_nodes, n_bins)
    mag = hm.level_histogram_plain(bins, node, gs.abs().double(),
                                   hs.abs().double(), ws.double(), n_nodes,
                                   n_bins)
    err, ratio = check_hist(f"K6 {label}", got, plain, ref, mag)
    del plain, ref, mag
    itemsize = 1 if bin_dtype == torch.uint8 else 2
    nbytes = hm.hist_bytes(n, F, itemsize, n_nodes, n_bins)
    copies = [[t.clone() for t in args]
              for _ in range(_copies(nbytes))]
    ms = _cuda_ms([lambda c=c: hm.level_histogram(*c, n_nodes, n_bins, **kw)
                   for c in copies], reps)
    plain_ms = _cuda_ms([lambda c=c: hm.level_histogram_plain(
        *c, n_nodes, n_bins, **kw) for c in copies], 3)
    del copies
    # library yardstick: one index_add_ of every (row, feature) pair's
    # stats into the flattened (n_nodes * F * n_bins, 3) output
    data = torch.stack([gs, hs, ws], -1)
    ids = ((node.long()[None] * F + torch.arange(F, device=dev)[:, None])
           * n_bins + hm.bins_as_int(bins).long()).reshape(-1)
    src = data.repeat(F, 1)
    out = torch.zeros(n_nodes * F * n_bins, 3, device=dev)
    library_ms = _cuda_ms([lambda: out.index_add_(0, ids, src)], 3)
    del ids, src, out
    torch.cuda.empty_cache()
    plan = hm.hist_launch_plan(n, F, n_nodes, n_bins, itemsize,
                               *hm._device_limits(dev))
    rec = {"max_abs_err": err, "err_over_bound": ratio, "ms": ms,
           "plain_ms": plain_ms,
           **_bound(dev_info, nbytes, 3 * n * F, peak="flops_f32"),
           "library_ms": library_ms, "plan": plan._asdict(),
           "shape": {"n": n, "F": F, "n_nodes": n_nodes, "n_bins": n_bins,
                     "bins": str(bin_dtype).split(".")[-1],
                     "stats": str(stats_dtype or torch.float32).split(".")[-1],
                     "bagged": bagged,
                     "few_values": [[list(c), list(v)]
                                    for c, v in few_values]}}
    log(f"[k6 {label}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


#: phase 8 at HIGGS's published size (scripts/bench_gbdt_higgs.py)
GBDT = dict(rows=11_000_000, features=28, iters=100, ragged=1_000_003,
            bin_rows=1_000_000)
#: phase 12b at UCI Covertype's published shape (581,012 rows, 54
#: features, 7 classes), 10% of the rows marked for validation
COVTYPE = dict(rows=581_012, features=54, classes=7, iters=100, valid=0.1)


def _class_hist_inputs(n, F, n_nodes, n_bins, K, seed, bin_dtype=None):
    """One multiclass level's K6 inputs on the card, from ``seed``:
    uniform bins (F, n), per-class uniform node ids (K, n), normal g and
    uniform h (K, n), w = 1 (n,)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, n_bins, (F, n), generator=gen, device=dev,
                         dtype=torch.int32).to(bin_dtype or torch.uint8)
    node = torch.randint(0, n_nodes, (K, n), generator=gen, device=dev,
                         dtype=torch.int32)
    g = torch.randn(K, n, generator=gen, device=dev)
    h = torch.rand(K, n, generator=gen, device=dev)
    return bins, node, g, h, torch.ones(n, device=dev)


def hist_class_cases():
    """Phase 8a's class-batched cases, (label, n, F, n_nodes, n_bins, K,
    seed, options): 12b's Covertype shape at 7 classes and 1, 4 and 16
    nodes (a depth-5 tree's first, third and last levels), and 3 classes
    on uint16 bins (1024 bins, 4 nodes)."""
    import torch
    n, F, K = COVTYPE["rows"], COVTYPE["features"], COVTYPE["classes"]
    return [(f"classes{K}_nodes{k}", n, F, k, 255, K, 40 + i, {})
            for i, k in enumerate((1, 4, 16))] + [
        ("classes3_uint16_bins1024", n, F, 4, 1024, 3, 43,
         {"bin_dtype": torch.int16})]


def _class_hist_case(dev_info, label, n, F, n_nodes, n_bins, K, seed,
                     bin_dtype=None, reps=20):
    """K6 over K classes in one launch against its plain version, then
    its time beside K single-class launches on the same inputs, the plain
    version, one ``index_add_`` over all K x n_nodes nodes' slots (the
    library yardstick) and the bound (the bins read once)."""
    import torch
    from mmlspark_tpu_torch.ops import histogram as hm

    dev = torch.device("cuda")
    bin_dtype = bin_dtype or torch.uint8
    args = _class_hist_inputs(n, F, n_nodes, n_bins, K, seed, bin_dtype)
    bins, node, g, h, w = args
    before = hm.level_histogram.launches
    got = hm.level_histogram(*args, n_nodes, n_bins)
    torch.cuda.synchronize()
    if hm.level_histogram.launches != before + 1:
        raise AssertionError(f"K6 {label}: {K} classes took "
                             f"{hm.level_histogram.launches - before} "
                             f"launches, not one")
    plain = hm.level_histogram_plain(*args, n_nodes, n_bins)
    ref = hm.level_histogram_plain(bins, node, g.double(), h.double(),
                                   w.double(), n_nodes, n_bins)
    mag = hm.level_histogram_plain(bins, node, g.abs().double(),
                                   h.abs().double(), w.double(), n_nodes,
                                   n_bins)
    err, ratio = check_hist(f"K6 {label}", got, plain, ref, mag)
    del got, plain, ref, mag
    itemsize = 1 if bin_dtype == torch.uint8 else 2
    nbytes = hm.hist_bytes(n, F, itemsize, n_nodes, n_bins, K)
    copies = [[t.clone() for t in args] for _ in range(_copies(nbytes))]
    ms = _cuda_ms([lambda c=c: hm.level_histogram(*c, n_nodes, n_bins)
                   for c in copies], reps)

    def singles(c):
        for k in range(K):
            hm.level_histogram(c[0], c[1][k], c[2][k], c[3][k], c[4],
                               n_nodes, n_bins)
    singles_ms = _cuda_ms([lambda c=c: singles(c) for c in copies], reps)
    plain_ms = _cuda_ms([lambda c=c: hm.level_histogram_plain(
        *c, n_nodes, n_bins) for c in copies], 3)
    del copies
    # library yardstick: one index_add_ of every (class, feature, row)
    # triple's stats into the flattened (K * n_nodes * F * n_bins, 3)
    # output
    cls = torch.arange(K, device=dev)[:, None, None]
    feat = torch.arange(F, device=dev)[None, :, None]
    ids = (((cls * n_nodes + node.long()[:, None]) * F + feat) * n_bins
           + hm.bins_as_int(bins).long()[None]).reshape(-1)
    src = torch.stack([g, h, w.expand(K, n)], -1)[:, None].expand(
        K, F, n, 3).reshape(-1, 3)
    out = torch.zeros(K * n_nodes * F * n_bins, 3, device=dev)
    library_ms = _cuda_ms([lambda: out.index_add_(0, ids, src)], 3)
    del ids, src, out
    torch.cuda.empty_cache()
    plan = hm.hist_launch_plan(n, F, n_nodes, n_bins, itemsize,
                               *hm._device_limits(dev), K)
    rec = {"max_abs_err": err, "err_over_bound": ratio, "ms": ms,
           "singles_ms": singles_ms, "plain_ms": plain_ms,
           **_bound(dev_info, nbytes, 3 * n * F * K, peak="flops_f32"),
           "bins_read_bytes": K * n * F * itemsize,
           "library_ms": library_ms, "plan": plan._asdict(),
           "shape": {"n": n, "F": F, "n_nodes": n_nodes, "n_bins": n_bins,
                     "classes": K, "bins": str(bin_dtype).split(".")[-1]}}
    log(f"[k6 {label}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def hist_sass():
    """The shared-memory atomics in the built K6 library's SASS, by opcode
    (``cuobjdump -sass``): what K6's design turned on (a shared
    f32 ``atomicAdd`` is an ``ATOMS.CAST.SPIN`` loop, an int32 add a native
    ``ATOMS``). None when the toolkit has no ``cuobjdump``."""
    import subprocess
    from pathlib import Path
    from mmlspark_tpu_torch.utils import cuda_build
    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass",
                           str(cuda_build.build_library("histogram"))],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for word in sass.split():
        if word.startswith("ATOMS."):
            counts[word] = counts.get(word, 0) + 1
    return counts


def hist_odd_rows():
    """K6 on rows it must drop (node ids -1 and n_nodes, bins past n_bins)
    and on count weights other than 0 or 1, once per body (lanes, table,
    chunked table, direct): its result against the plain version over
    the rows it keeps, counts and g/h within phase 8a's bound (a
    fractional weight is added in no fixed order). Returns
    {body: max error over the bound}."""
    import torch
    from mmlspark_tpu_torch.ops import histogram as hm
    dev = torch.device("cuda")
    out = {}
    for label, n_nodes, n_bins in (("lanes", 1, 200), ("table", 16, 200),
                                   ("table chunked", 97, 200),
                                   ("direct", 256, 200)):
        n, F = 30_001, 5
        bins, node, g, h, w = _hist_inputs(n, F, n_nodes, n_bins, 30)
        node[::97] = -1
        node[5::101] = n_nodes
        bins[2, 7::89] = 250                     # past n_bins: dropped
        w[::83] = 0.5
        plan = hm.hist_launch_plan(n, F, n_nodes, n_bins, 1,
                                   *hm._device_limits(dev))
        if plan.body != label.split()[0] or (plan.chunks > 1) != (
                label == "table chunked"):
            raise AssertionError(f"K6 odd rows: {label} case planned as "
                                 f"{plan.body}")
        got = hm.level_histogram(bins, node, g, h, w, n_nodes, n_bins)
        keep = (node >= 0) & (node < n_nodes)
        kb = bins[:, keep].clone()
        dropped = kb[2] >= n_bins
        kb[2][dropped] = 0
        args = (kb, node[keep], g[keep], h[keep], w[keep])
        ref = hm.level_histogram_plain(
            args[0], args[1], *(t.double() for t in args[2:]), n_nodes,
            n_bins)
        mag = hm.level_histogram_plain(
            args[0], args[1], *(t.abs().double() for t in args[2:]),
            n_nodes, n_bins)
        # feature 2 without its dropped rows
        k2 = ~dropped
        ref[:, 2] = hm.level_histogram_plain(
            kb[:, k2], args[1][k2], *(t[k2].double() for t in args[2:]),
            n_nodes, n_bins)[:, 2]
        mag[:, 2] = hm.level_histogram_plain(
            kb[:, k2], args[1][k2], *(t[k2].abs().double() for t in args[2:]),
            n_nodes, n_bins)[:, 2]
        err = (got.double() - ref).abs()
        ratio = (err / (2e-6 * mag + 1e-7)).max().item()
        if not torch.isfinite(got).all() or ratio > 1:
            raise AssertionError(f"K6 odd rows ({label}): off by {ratio} "
                                 f"of the bound")
        out[label] = ratio
    log(f"[k6 odd rows] {json.dumps(out)}")
    return out


def phase_hist_kernel(dev_info):
    """8a: K6 against its plain version at every case of ``hist_cases``
    and ``hist_class_cases``, on rows it must drop and fractional count
    weights, and the
    shared-memory atomics its library compiled to. Returns (the cases'
    records, the SASS counts)."""
    recs = {label: _hist_case(dev_info, label, *shape, **opts)
            for label, *shape, opts in hist_cases()}
    recs.update({label: _class_hist_case(dev_info, label, *shape, **opts)
                 for label, *shape, opts in hist_class_cases()})
    hist_odd_rows()
    sass = hist_sass()
    log(f"[k6 sass] {json.dumps(sass)}")
    return recs, sass


def _tree_ties(what, kernel, plain):
    """One tree's splits through K6 against the same through the plain
    version, each (feats, thr_bins, gains) as numpy: the same split at
    every node, or a tie (gains within 1e-5 relative) that is returned.
    Nodes below a tie are not compared (their rows differ)."""
    (fk, tk, gk), (fp, tp, gp) = kernel, plain
    ties, tied = [], set()
    for i in range(len(fk)):
        anc, a = False, i
        while a > 0:
            a = (a - 1) // 2
            anc = anc or a in tied
        if anc or (fk[i], tk[i]) == (fp[i], tp[i]):
            continue
        gap = abs(float(gk[i]) - float(gp[i])) / max(abs(float(gp[i])), 1e-30)
        log(f"[{what}] node {i}: kernel ({fk[i]}, {tk[i]}) gain "
            f"{gk[i]!r} vs plain ({fp[i]}, {tp[i]}) gain {gp[i]!r}")
        if gap > 1e-5:
            raise AssertionError(f"{what}: node {i} splits differ with "
                                 f"a gain gap of {gap:.3g} relative")
        ties.append({"node": i, "kernel": [int(fk[i]), int(tk[i])],
                     "plain": [int(fp[i]), int(tp[i])],
                     "gain_kernel": float(gk[i]), "gain_plain": float(gp[i])})
        tied.add(i)
    return ties


def phase_tree_parity(X, y, dev_info, depth=5):
    """8b: one full-size tree (num_leaves 31, depth 5) at the binary
    objective's first-iteration g/h, built through K6 and through the
    plain version on the card: the same split at every node, or a tie
    (gains within 1e-5 relative) that is recorded. Nodes below a tie are
    not compared (their rows differ)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.models.gbdt.objectives import get_objective
    from mmlspark_tpu_torch.models.gbdt.train import bins_on_device
    from mmlspark_tpu_torch.models.gbdt.trees import build_tree
    from mmlspark_tpu_torch.utils.device import resolve_device
    dev = resolve_device()
    mapper = BinMapper(max_bin=255, seed=0).fit(X)
    bins = bins_on_device(mapper, X, dev)[0]
    obj = get_objective("binary")
    w = np.ones(len(y))
    base = torch.tensor(obj.init_score(y, w), dtype=torch.float32, device=dev)
    y_d = torch.as_tensor(y, dtype=torch.float32).to(dev)
    live = torch.ones(len(y), dtype=torch.float32, device=dev)
    g, h = obj.grad_hess(torch.zeros_like(y_d) + base, y_d, live)
    kw = dict(depth=depth, n_bins=mapper.n_bins, lam=1e-10, alpha=0.0,
              min_gain=0.0, min_child_weight=1e-3, min_data_in_leaf=20.0)
    outs = {impl: [t.cpu().numpy() for t in build_tree(
        bins, g, h, live, hist_impl=impl, **kw)]
        for impl in ("kernel", "plain")}
    (fk, tk, lk, _, gk, _), (fp, tp, lp, _, gp, _) = (outs["kernel"],
                                                      outs["plain"])
    ties = _tree_ties("tree parity", (fk, tk, gk), (fp, tp, gp))
    rec = {"rows": len(y), "depth": depth, "nodes": len(fk),
           "stub_nodes": int((fk < 0).sum()),
           "identical": not ties, "ties": ties,
           "leaf_max_abs_diff": float(np.abs(lk - lp).max()) if not ties
           else None}
    log(f"[tree parity] {json.dumps(rec)} | {dev_info['smi']}")
    del bins
    torch.cuda.empty_cache()
    return rec


def phase_binning(X, dev_info):
    """8c's binning: the native loop and the numpy loop (its plain
    version) on the same first ``GBDT["bin_rows"]`` rows of the HIGGS
    matrix, in one call: the bins bitwise equal, and each loop's
    seconds."""
    import numpy as np
    from mmlspark_tpu_torch.models.gbdt.binning import (BinMapper,
                                                        bin_columns,
                                                        bin_columns_plain)
    part = X[:GBDT["bin_rows"]]
    table, lengths = BinMapper(max_bin=255, seed=0).fit(X).bounds_table()
    secs = {}
    out = {}
    for name, fn in (("native", bin_columns), ("numpy", bin_columns_plain),
                     ("native_again", bin_columns)):
        t0 = time.perf_counter()
        out[name] = fn(part, table, lengths, False)
        secs[name] = time.perf_counter() - t0
    if not (np.array_equal(out["native"], out["numpy"])
            and np.array_equal(out["native_again"], out["numpy"])):
        raise AssertionError("the native loop's bins differ from numpy's")
    rec = {"rows": len(part), "features": X.shape[1],
           "native_s": secs["native"], "native_again_s": secs["native_again"],
           "numpy_s": secs["numpy"],
           "numpy_over_native": secs["numpy"] / min(secs["native"],
                                                    secs["native_again"]),
           "ns_per_element_native": min(secs["native"], secs["native_again"])
           / part.size * 1e9,
           "ns_per_element_numpy": secs["numpy"] / part.size * 1e9,
           "bitwise_equal": True}
    log(f"[binning] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_gbdt(X, y, dev_info, hist_recs):
    """8c: ``train()`` at ``device=None`` on the HIGGS-shaped matrix, after
    a 1-iteration warm-up: K6 must launch exactly 5 times per iteration
    and the plain version never; every bin from the native loop and none
    from numpy; train AUC above 0.75; the model string round trip
    predicts bitwise the same on the card. Returns (its record, the
    booster)."""
    import numpy as np
    from mmlspark_tpu_torch.models.gbdt import Booster, train
    from mmlspark_tpu_torch.utils.device import resolve_device
    iters = GBDT["iters"]
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "num_iterations": iters}
    t0 = time.perf_counter()
    train({**params, "num_iterations": 1}, X, y)
    warm = time.perf_counter() - t0
    _zero_launch_counts()
    t0 = time.perf_counter()
    b = train(params, X, y)
    wall = time.perf_counter() - t0
    launches = _check_counts("8c train()", iters)
    bins_native = _launch_counts()[2]
    if b.num_trees != iters or b.device != resolve_device():
        raise AssertionError(f"{b.num_trees} trees on {b.device}")
    t0 = time.perf_counter()
    p = b.predict(X)
    predict_s = time.perf_counter() - t0
    if p.shape != (len(y),) or not np.isfinite(p).all():
        raise AssertionError(f"predictions {p.shape}, finite "
                             f"{np.isfinite(p).all()}")
    auc = _auc(y, p)
    if auc <= 0.75:
        raise AssertionError(f"train AUC {auc} <= 0.75")
    p2 = Booster.from_string(b.to_string()).predict(X)
    if not np.array_equal(p, p2):
        raise AssertionError("the model string round trip predicts "
                             "differently")
    ph = b.phase_seconds
    sec_iter = ph["boost"] / iters
    k6_ms = sum(hist_recs[f"nodes{k}"]["ms"] for k in (1, 2, 4, 8, 16))
    rec = {"rows": len(y), "features": X.shape[1], "iterations": iters,
           "num_leaves": 31, "bin_fit_s": ph["bin_fit"],
           "bin_transform_s": ph["bin_transform"], "upload_s": ph["upload"],
           "boost_s": ph["boost"], "sec_per_iter": sec_iter,
           "train_wall_s": wall, "warmup_wall_s": warm,
           "predict_s": predict_s, "train_auc": auc,
           "k6_launches": launches, "k6_ms_per_iter": k6_ms,
           "k6_share_of_iter": k6_ms / (sec_iter * 1e3),
           "bin_native_calls": bins_native,
           "stub_nodes": int((b.feats < 0).sum())}
    log(f"[gbdt] {json.dumps(rec)} | {dev_info['smi']}")
    return rec, b


def _launch_counts():
    """(K6 launches, plain K6 calls, native and numpy binning calls)."""
    from mmlspark_tpu_torch.models.gbdt.binning import bin_columns
    from mmlspark_tpu_torch.ops.histogram import (level_histogram,
                                                  level_histogram_plain)
    return (level_histogram.launches, level_histogram_plain.calls,
            bin_columns.native_calls, bin_columns.plain_calls)


def _zero_launch_counts():
    from mmlspark_tpu_torch.models.gbdt.binning import bin_columns
    from mmlspark_tpu_torch.ops.histogram import (level_histogram,
                                                  level_histogram_plain)
    level_histogram.launches = level_histogram_plain.calls = 0
    bin_columns.native_calls = bin_columns.plain_calls = 0


def _check_counts(what, iters):
    """The main path's counts since :func:`_zero_launch_counts`: 5 K6
    launches an iteration (num_leaves 31), no plain K6 call, the bins
    from the native loop only. Returns the K6 launches."""
    k6, plain, native, numpy_ = _launch_counts()
    if k6 != 5 * iters or plain != 0 or native == 0 or numpy_ != 0:
        raise AssertionError(f"{what}: K6 launches {k6} (want {5 * iters}), "
                             f"plain calls {plain} (want 0), binning "
                             f"{native} native / {numpy_} numpy calls")
    return k6


def phase_estimator_higgs(X, y, dev_info, b8c):
    """12a: the north-star configuration through the estimator: the
    HIGGS-shaped matrix as a ``DataFrame`` (a 2-D float ``features``
    column and ``label``), ``LightGBMClassifier(device=None).fit`` with
    8c's params; time to model (fit wall, binning, upload, sec/iter); 5
    K6 launches an iteration; the booster against 8c's ``train()`` on the
    same matrix (the same code path on one card, the same bins): not
    bitwise, since K6 adds g and h in an order that changes from run to
    run (ROADMAP.md, queue item 22), so as many trees, each tree's splits
    compared, and on the transformed rows the same AUC within 1e-4 and
    probabilities within 1e-4 on average; ``transform`` of the first
    ``GBDT["bin_rows"]`` rows: probability equal to ``Booster.predict``
    bitwise, train AUC above 0.75."""
    import numpy as np
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier
    iters = GBDT["iters"]
    df = DataFrame({"features": X, "label": y})
    est = LightGBMClassifier(num_leaves=31, max_bin=255, learning_rate=0.1,
                             num_iterations=iters, min_data_in_leaf=20)
    _zero_launch_counts()
    t0 = time.perf_counter()
    model = est.fit(df)
    fit_s = time.perf_counter() - t0
    launches = _check_counts("12a fit", iters)
    b = model.booster
    if b.num_trees != b8c.num_trees:
        raise AssertionError(f"12a: {b.num_trees} trees, 8c {b8c.num_trees}")
    same_splits = [bool(np.array_equal(b.feats[t], b8c.feats[t])
                        and np.array_equal(b.thr_raw[t], b8c.thr_raw[t]))
                   for t in range(b.num_trees)]
    rows = GBDT["bin_rows"]
    t0 = time.perf_counter()
    out = model.transform(DataFrame({"features": X[:rows]}))
    transform_s = time.perf_counter() - t0
    prob = np.stack(out["probability"])
    want = b.predict(X[:rows])
    if prob.shape != (rows, 2) or not np.array_equal(prob[:, 1], want):
        raise AssertionError("12a: the probability column differs from "
                             "Booster.predict")
    if not np.array_equal(out["prediction"], np.argmax(
            np.stack([1 - want, want], axis=1), axis=1).astype(float)):
        raise AssertionError("12a: prediction is not the argmax")
    auc = _auc(y[:rows], prob[:, 1])
    if auc <= 0.75:
        raise AssertionError(f"12a: train AUC {auc} <= 0.75")
    p8c = b8c.predict(X[:rows])
    auc8c, dp = _auc(y[:rows], p8c), np.abs(want - p8c)
    if abs(auc - auc8c) > 1e-4 or dp.mean() > 1e-4:
        raise AssertionError(f"12a: AUC {auc} vs 8c's {auc8c}, mean |dp| "
                             f"{dp.mean()} (bounds 1e-4)")
    ph = b.phase_seconds
    rec = {"rows": len(y), "features": X.shape[1], "iterations": iters,
           "fit_wall_s": fit_s, "bin_fit_s": ph["bin_fit"],
           "bin_transform_s": ph["bin_transform"], "upload_s": ph["upload"],
           "boost_s": ph["boost"], "sec_per_iter": ph["boost"] / iters,
           "fit_other_s": fit_s - sum(ph.values()),
           "transform_rows": rows, "transform_s": transform_s,
           "train_auc_first_rows": auc, "k6_launches": launches,
           "vs_8c": {"model_string_equal": b.to_string() == b8c.to_string(),
                     "trees_with_equal_splits": sum(same_splits),
                     "first_differing_tree": (same_splits.index(False)
                                              if not all(same_splits)
                                              else None),
                     "leaf_max_abs_diff": float(np.abs(
                         b.leaf_values - b8c.leaf_values).max()),
                     "auc_8c": auc8c, "prob_max_abs_diff": float(dp.max()),
                     "prob_mean_abs_diff": float(dp.mean())}}
    log(f"[estimator 12a] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def make_covtype_like(n, f, k, seed=0):
    """A Covertype-shaped problem from ``seed``: standard-normal features
    and labels the argmax of a seeded linear map of them plus seeded
    noise (learnable, not separable). The map weighs 4 of the features
    for each class, as Covertype's classes turn on a few of its columns
    (elevation above all)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    W = np.zeros((f, k), dtype=np.float32)
    for c in range(k):
        W[rng.choice(f, 4, replace=False), c] = rng.normal(0, 1, 4)
    noise = rng.normal(0, 1.0, (n, k)).astype(np.float32)
    return X, np.argmax(X @ W + noise, axis=1).astype(np.float64)


def _k6_level_ms(n, F, K, n_bins, depth):
    """K6's device ms for one tree's levels (1 ... 2^(depth-1) nodes) at
    K classes, on random inputs of the training shape."""
    import torch
    from mmlspark_tpu_torch.ops import histogram as hm
    total = 0.0
    for d in range(depth):
        args = _class_hist_inputs(n, F, 2 ** d, n_bins, K, 50 + d)
        total += _cuda_ms([lambda: hm.level_histogram(*args, 2 ** d, n_bins)],
                          10)
    torch.cuda.empty_cache()
    return total


def phase_multiclass(dev_info):
    """12b: 7-class ``LightGBMClassifier(objective="multiclass")`` at
    Covertype's shape with 10% of the rows marked for validation: one K6
    launch a level for all classes (5 an iteration, not 35) and no plain
    call; the first iteration's 7 trees through K6 equal those through
    the plain version on the card (or a recorded tie); training
    multi-logloss below ln 7 / 2; probability rows summing to 1 within
    1e-6; a bitwise model string round trip; sec/iter and K6's share."""
    import math
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.gbdt import (Booster, BinMapper,
                                                LightGBMClassifier)
    from mmlspark_tpu_torch.models.gbdt.objectives import (get_metric,
                                                           get_objective)
    from mmlspark_tpu_torch.models.gbdt.train import bins_on_device
    from mmlspark_tpu_torch.models.gbdt.trees import build_tree
    from mmlspark_tpu_torch.utils.device import resolve_device
    n, F, K, iters = (COVTYPE["rows"], COVTYPE["features"],
                      COVTYPE["classes"], COVTYPE["iters"])
    X, y = make_covtype_like(n, F, K)
    valid = np.random.default_rng(1).random(n) < COVTYPE["valid"]
    df = DataFrame({"features": X, "label": y, "is_valid": valid})
    est = LightGBMClassifier(objective="multiclass", num_leaves=31,
                             max_bin=255, learning_rate=0.1,
                             num_iterations=iters,
                             validation_indicator_col="is_valid")
    _zero_launch_counts()
    t0 = time.perf_counter()
    model = est.fit(df)
    fit_s = time.perf_counter() - t0
    launches = _check_counts("12b fit", iters)
    b = model.booster
    if b.num_class != K or b.num_trees != K * iters:
        raise AssertionError(f"12b: {b.num_trees} trees of {b.num_class} "
                             f"classes")
    # the first iteration's trees, through K6 and through the plain version
    Xt, yt = X[~valid], y[~valid]
    dev = resolve_device()
    mapper = BinMapper(max_bin=255, seed=0).fit(Xt)
    bins = bins_on_device(mapper, Xt, dev)[0]
    y_d = torch.as_tensor(yt, dtype=torch.float32).to(dev)
    live = torch.ones(len(yt), dtype=torch.float32, device=dev)
    g, h = get_objective("multiclass", num_class=K).grad_hess(
        torch.zeros(len(yt), K, device=dev), y_d, live)
    g, h = g.T.contiguous(), h.T.contiguous()
    kw = dict(depth=5, n_bins=mapper.n_bins, lam=1e-10, alpha=0.0,
              min_gain=0.0, min_child_weight=1e-3, min_data_in_leaf=20.0)
    outs = {impl: [t.cpu().numpy() for t in build_tree(
        bins, g, h, live, hist_impl=impl, **kw)]
        for impl in ("kernel", "plain")}
    (fk, tk, _, _, gk, _), (fp, tp, _, _, gp, _) = (outs["kernel"],
                                                    outs["plain"])
    ties = {k: _tree_ties(f"12b class {k}", (fk[k], tk[k], gk[k]),
                          (fp[k], tp[k], gp[k])) for k in range(K)}
    ties = {k: v for k, v in ties.items() if v}
    fit_first_equal_plain = bool(np.array_equal(b.feats[:K], fp))
    del bins, g, h
    torch.cuda.empty_cache()
    # training loss, the transform's probabilities, the model string
    p_train = b.predict(Xt)
    logloss = get_metric("multi_logloss")[1][0](yt, p_train, np.ones(len(yt)))
    if not logloss < math.log(K) / 2:
        raise AssertionError(f"12b: training multi-logloss {logloss} not "
                             f"below ln {K} / 2")
    t0 = time.perf_counter()
    out = model.transform(df)
    transform_s = time.perf_counter() - t0
    prob = np.stack(out["probability"])
    if prob.shape != (n, K) or not np.isfinite(prob).all() or \
            np.abs(prob.sum(axis=1) - 1).max() > 1e-6:
        raise AssertionError("12b: probability rows do not sum to 1")
    again = Booster.from_string(b.to_string())
    if again.to_string() != b.to_string() or not np.array_equal(
            again.predict(X[valid]), b.predict(X[valid])):
        raise AssertionError("12b: the model string round trip differs")
    valid_logloss = get_metric("multi_logloss")[1][0](
        y[valid], b.predict(X[valid]), np.ones(int(valid.sum())))
    ph = b.phase_seconds
    sec_iter = ph["boost"] / iters
    k6_ms = _k6_level_ms(len(yt), F, K, mapper.n_bins, 5)
    rec = {"rows": n, "train_rows": len(yt), "valid_rows": int(valid.sum()),
           "features": F, "classes": K, "iterations": iters,
           "fit_wall_s": fit_s, "bin_fit_s": ph["bin_fit"],
           "bin_transform_s": ph["bin_transform"], "upload_s": ph["upload"],
           "boost_s": ph["boost"], "sec_per_iter": sec_iter,
           "k6_launches": launches, "k6_launches_per_iter": launches / iters,
           "k6_ms_per_iter": k6_ms,
           "k6_share_of_iter": k6_ms / (sec_iter * 1e3),
           "train_multi_logloss": logloss, "valid_multi_logloss":
           valid_logloss, "transform_s": transform_s,
           "first_iteration_ties": ties,
           "first_iteration_fit_equals_plain": fit_first_equal_plain}
    log(f"[multiclass 12b] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


# ---- phase 9: flash attention (K7, K8a, K8b) -------------------------------

#: the repo's BERT_BASE (models/zoo/transformer.py:74): the published
#: BERT-base widths, LayerNorm, learned positions, non-causal
BERT = dict(vocab=30522, layers=12, d_model=768, heads=12, d_ff=3072,
            max_len=512)
#: 9a shapes: label -> (B, H, S, D, causal, mask): mask "padded" is
#: ``_ragged_mask`` (one fully padded row), "lengths" is 9c's
#: ``_lengths_mask``, "holes" is ``_holes_mask``, None is no mask.
#: "infer", "train" and "decoder" are the main paths' own: 9c's
#: inference, 9d's training and 9d's causal decoder.
FLASH_CASES = {"bert": (8, 12, 512, 64, False, "padded"),
               "causal": (2, 12, 2048, 64, True, None),
               "unaligned": (2, 4, 200, 32, False, "padded"),
               "d128": (2, 8, 512, 128, True, "padded"),
               "infer": (32, 12, 512, 64, False, "lengths"),
               "train": (16, 12, 512, 64, False, None),
               "decoder": (4, 12, 2048, 64, True, None),
               "holes": (2, 4, 192, 64, False, "holes"),
               "holes_d128": (3, 4, 200, 128, True, "holes")}
#: the 9a shapes timed (in bf16), beside their plain versions and SDPA
FLASH_TIMED = ("bert", "causal", "infer", "train", "decoder")


def _ragged_mask(B, S, gen, dev):
    """BERT padding masks: row b keeps a random prefix of its keys, row 1
    keeps none (a fully padded sequence)."""
    import torch
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    lengths[0] = S
    lengths[1] = 0
    return torch.arange(S, device=dev)[None] < lengths[:, None]


def _holes_mask(B, S, gen, dev):
    """Non-prefix masks: 70% of the keys at random, with keys 64 ... 127
    (one whole key tile) masked in every row and the last row masked
    whole."""
    import torch
    mask = torch.rand(B, S, generator=gen, device=dev) < 0.7
    mask[:, 64:128] = False
    mask[-1] = False
    return mask


def _lengths_mask(B, S, gen, dev):
    """9c's padding masks: row b keeps its first 64 ... S keys."""
    import torch
    lengths = torch.randint(64, S + 1, (B,), generator=gen, device=dev)
    return torch.arange(S, device=dev)[None] < lengths[:, None]


def _ulp_check(what, got, want, rel=None):
    """``got`` against the plain version's result ``want`` (f32, computed
    from the same inputs). f32 output: within 1e-5 * max|want| (the sums
    run in another order). bf16 output: within 2 bf16 ulps of ``want``
    plus 1e-5 * max|want| (the rounding to bf16, and near-zero entries
    whose ulp is below the f32 summation error), plus 2^-8 * ``rel``
    where given: ``rel`` is the output taken over absolute values
    (``bf16_rounding_scale``), for the bf16 K7's o, K8a's dK and dV and
    K8b's dQ, which round each P or dS element to bf16 once before a
    tensor-core product (2^-8 is bf16's unit roundoff). Returns
    max_abs_err."""
    import torch
    want = want.float()
    diff = (got.float() - want).abs()
    floor = 1e-5 * want.abs().max().item()
    if got.dtype == torch.bfloat16:
        mag = want.abs().clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        allowed = 2 * ulp + floor
        if rel is not None:
            allowed = allowed + 2.0 ** -8 * rel
        bad = diff > allowed
    else:
        bad = diff > floor
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()) or \
            bad.any():
        raise AssertionError(f"{what}: off by more than the stated bound at "
                             f"{int(bad.sum())} elements, or not finite "
                             f"(max_abs_err {diff.max().item()})")
    return diff.max().item()


def _flash_inputs(B, H, S, D, mask_kind, dtype, seed):
    """Random q/k/v/dO on the card, the mask (or None) and NaN planted in
    every key/value row past the mask."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    make = {"padded": _ragged_mask, "lengths": _lengths_mask,
            "holes": _holes_mask}.get(mask_kind)
    mask = None if make is None else make(B, S, gen, dev)
    if mask is not None:
        dead = ~mask[:, None, :, None].expand(B, H, S, D)
        k[dead] = float("nan")
        v[dead] = float("nan")
    return q, k, v, do, mask


def _flash_case(dev_info, label, dtype, seed, timed):
    """K7 (with and without stats), K8a and K8b against their plain
    versions at one 9a shape; then, when ``timed``, their times beside
    the plain versions', one SDPA call (forward, and its autograd
    backward) and the bounds."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.ops import flash_attention as fa

    B, H, S, D, causal, mask_kind = FLASH_CASES[label]
    q, k, v, do, mask = _flash_inputs(B, H, S, D, mask_kind, dtype, seed)
    scale = D ** -0.5
    name = f"{label} {str(dtype).split('.')[-1]}"
    o0 = fa.flash_attention(q, k, v, kv_mask=mask, causal=causal)
    o, l, m = fa._fwd_kernel(q, k, v, mask, causal, scale, True)
    dq, dk, dv = fa._bwd_kernel(q, k, v, mask, o, l, m, do, causal, scale)
    torch.cuda.synchronize()
    # the plain versions in f32 on the same inputs (the kernel's o, l, m
    # feed both backwards, as the autograd function feeds them)
    f32 = [t.float() for t in (q, k, v)]
    wo, wl, wm = fa.flash_attention_plain(*f32, mask, causal=causal)
    wq, wk, wv = fa.flash_attention_bwd_plain(*f32, mask, o.float(), l, m,
                                              do.float(), causal=causal)
    r_o = r_dq = r_dk = r_dv = None
    if dtype == torch.bfloat16:
        r_o, r_dq, r_dk, r_dv = fa.bf16_rounding_scale(
            *f32, mask, o.float(), l, m, do.float(), causal=causal)
    err = {"K7": _ulp_check(f"K7 {name}", o0, wo, r_o),
           "K7 stats": _ulp_check(f"K7 stats {name}", o, wo, r_o),
           "K8a": max(_ulp_check(f"K8a dK {name}", dk, wk, r_dk),
                      _ulp_check(f"K8a dV {name}", dv, wv, r_dv)),
           "K8b": _ulp_check(f"K8b dQ {name}", dq, wq, r_dq)}
    if not torch.equal(o0, o):
        raise AssertionError(f"K7 {name}: with and without stats differ")
    live = wl > 0
    if not torch.equal(live, l > 0) or \
            (l[live] - wl[live]).abs().max().item() > 1e-5 * \
            wl.max().item() or \
            (m[live] - wm[live]).abs().max().item() > 1e-5 * \
            wm[live].abs().max().item():
        raise AssertionError(f"K7 stats {name}: l/m off by more than "
                             f"1e-5 of their largest value")
    dead = None if mask is None else ~mask.any(-1)
    if dead is not None and bool(dead.any()):
        outs = (o, l, dq, dk, dv)
        if not all(t[dead].abs().max().item() == 0.0 for t in outs) or \
                not bool((m[dead] == -1e30).all()):
            raise AssertionError(f"{name}: the fully masked row is not "
                                 f"exactly 0 (l = 0, m = -1e30, grads 0)")
    rec = {k2: {"max_abs_err": e} for k2, e in err.items()}
    log(f"[flash {name}] max_abs_err {json.dumps(err)}")
    if not timed:
        return rec
    lib = fa._library()
    code = fa._DTYPES[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    it = q.element_size()
    slab = B * H * S * D * it
    mptr = None if mask is None else mask.data_ptr()
    delta = fa._delta(do, o)
    n_in = _copies(4 * slab)
    copies = [[t.clone() for t in (q, k, v, do)] for _ in range(n_in)]
    rc = []

    def fwd(c, stats):
        outs = (o.data_ptr(), l.data_ptr() if stats else None,
                m.data_ptr() if stats else None)
        return lambda: rc.append(lib.mmlspark_fa_fwd(
            code, D, c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(),
            mptr, *outs, B * H, H, S, scale, int(causal), stream))

    def bwd(c, which):
        common = (c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(), mptr,
                  c[3].data_ptr(), m.data_ptr(), l.data_ptr(),
                  delta.data_ptr())
        if which == "dkv":
            return lambda: rc.append(lib.mmlspark_fa_bwd_dkv(
                code, D, *common, dk.data_ptr(), dv.data_ptr(), B * H, H, S,
                scale, int(causal), stream))
        return lambda: rc.append(lib.mmlspark_fa_bwd_dq(
            code, D, *common, dq.data_ptr(), B * H, H, S, scale,
            int(causal), stream))

    ms = {"K7": _cuda_ms([fwd(c, False) for c in copies], 50),
          "K7 stats": _cuda_ms([fwd(c, True) for c in copies], 50),
          "K8a": _cuda_ms([bwd(c, "dkv") for c in copies], 30),
          "K8b": _cuda_ms([bwd(c, "dq") for c in copies], 30)}
    if any(rc):
        raise AssertionError(f"flash {name}: launch returned {set(rc)}")
    plain_fwd = _cuda_ms([lambda c=c: fa.flash_attention_plain(
        c[0], c[1], c[2], mask, causal=causal) for c in copies], 5)
    plain_bwd = _cuda_ms([lambda c=c: fa.flash_attention_bwd_plain(
        c[0], c[1], c[2], mask, o, l, m, c[3], causal=causal)
        for c in copies], 5)
    # library yardstick: SDPA with the same boolean mask (the fully padded
    # row attends everything instead: SDPA gives NaN there), and the
    # autograd backward of that call; the port never calls either
    sdpa_mask = None
    if mask is not None:
        lm = mask.clone()
        lm[~lm.any(-1)] = True
        sdpa_mask = lm[:, None, None, :]
    clean = [torch.nan_to_num(t) for t in (q, k, v)]
    lib_fwd = _cuda_ms([lambda: F.scaled_dot_product_attention(
        *clean, attn_mask=sdpa_mask, is_causal=causal)], 50)
    leaves = [t.clone().requires_grad_(True) for t in clean]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask,
                                         is_causal=causal)
    lib_bwd = _cuda_ms([lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True)], 20)
    del copies, leaves, out
    torch.cuda.empty_cache()
    # what this input needs: the flops of the valid (query, key) pairs;
    # K and V rows only where a key is valid (a masked row is never read),
    # q and dO only for batch rows with a valid key, every output in full
    pairs = H * fa.attention_pairs(mask, B, S, causal)
    peak = "flops" if dtype == torch.bfloat16 else "flops_f32"
    if mask is None:
        kv_frac = live_frac = 1.0
        mbytes = 0
    else:
        kv_frac = mask.float().mean().item()
        live_frac = mask.any(-1).float().mean().item()
        mbytes = B * S
    kv, qin = 2 * slab * kv_frac, slab * live_frac
    stats = 3 * B * H * S * 4                     # m, l, delta (f32)
    bounds = {"K7": _bound(dev_info, qin + kv + slab + mbytes,
                           4 * D * pairs, peak),
              "K7 stats": _bound(dev_info, qin + kv + slab + mbytes
                                 + 2 * B * H * S * 4, 4 * D * pairs, peak),
              "K8a": _bound(dev_info, 2 * qin + kv + 2 * slab + stats
                            + mbytes, 8 * D * pairs, peak),
              "K8b": _bound(dev_info, 2 * qin + kv + slab + stats + mbytes,
                            6 * D * pairs, peak)}
    shape = {"B": B, "H": H, "S": S, "D": D, "causal": causal,
             "mask": {"padded": "ragged, one fully padded row",
                      "lengths": "ragged, 64 ... S keys"}.get(mask_kind),
             "dtype": str(dtype).split(".")[-1], "pairs": pairs,
             "valid_key_share": kv_frac}
    for key in rec:
        fwd_side = key.startswith("K7")
        rec[key].update({"ms": ms[key],
                         "plain_ms": plain_fwd if fwd_side else plain_bwd,
                         **bounds[key],
                         "library_ms": lib_fwd if fwd_side else lib_bwd,
                         "shape": shape})
    log(f"[flash {name}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_flash_kernels(dev_info):
    """9a: every shape in bf16 and f32; times at the ``FLASH_TIMED`` shapes
    in bf16."""
    import torch
    recs = {}
    for i, label in enumerate(FLASH_CASES):
        for j, dtype in enumerate((torch.bfloat16, torch.float32)):
            timed = dtype == torch.bfloat16 and label in FLASH_TIMED
            recs[f"{label} {str(dtype).split('.')[-1]}"] = _flash_case(
                dev_info, label, dtype, 90 + 2 * i + j, timed)
    return recs


def _bert_cfg(torch_dtype, **kw):
    from mmlspark_tpu_torch.models.zoo.transformer import TransformerConfig
    return TransformerConfig(dtype=torch_dtype, **{**BERT, **kw})


def phase_flash_parity(bert_np, dev_info):
    """9b: BERT-base in f32, B = 2, S = 512 with ragged masks (one fully
    padded row): the flash forward through the kernels against the same
    model on the host, where the port runs the plain versions; the dense
    path against flash on the rows that are not fully padded; the
    gradients of ``loss_fn`` through the kernels against those on the
    host."""
    import torch
    from mmlspark_tpu_torch.models.zoo import transformer as tf
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = _bert_cfg(torch.float32, use_flash=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S = 2, 512
    ids = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    mask = _ragged_mask(B, S, gen, dev)
    mask[0, 400:] = False
    host = {"ids": ids.to(cpu), "labels": labels.to(cpu),
            "mask": mask.to(cpu)}
    flash_attention.launches = flash_attention.launches_dkv = 0
    flash_attention.launches_dq = 0
    flash_attention_plain.calls = flash_attention_bwd_plain.calls = 0
    with torch.no_grad():
        params = tf.params_from_numpy(bert_np, cfg, dev)
        hk = tf.transformer_apply(params, ids, cfg, mask=mask)
        hd = tf.transformer_apply(params, ids, cfg._replace(use_flash=False),
                                  mask=mask)
        del params
        hp = tf.transformer_apply(tf.params_from_numpy(bert_np, cfg, cpu),
                                  host["ids"], cfg, mask=host["mask"])
    if flash_attention.launches != cfg.layers or \
            flash_attention_plain.calls != cfg.layers:
        raise AssertionError(f"9b: {flash_attention.launches} K7 launches, "
                             f"{flash_attention_plain.calls} plain calls, "
                             f"want {cfg.layers} each")
    fwd_err = (hk.cpu() - hp).abs().max().item()
    dense_err = (hk[0] - hd[0]).abs().max().item()
    # f32 hidden states after the final LayerNorm are O(1): the card and
    # the host differ in the attention's and every matmul's summation
    # order, carried through 12 layers; dense differs also by exp
    # underflow vs the mask
    if not torch.isfinite(hk).all() or fwd_err > 1e-4 or dense_err > 1e-4:
        raise AssertionError(f"9b: hidden kernel-vs-plain {fwd_err}, "
                             f"flash-vs-dense {dense_err} (bound 1e-4)")
    grads, losses = {}, {}
    for run, d in (("kernel", dev), ("plain", cpu)):
        master = tf.params_from_numpy(bert_np, cfg, d, master=True)
        leaves = tf.tree_leaves(master)
        ids_r, labels_r = (ids, labels) if d == dev else \
            (host["ids"], host["labels"])
        loss = tf.loss_fn(master, ids_r, labels_r, cfg)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads[run] = [None if x is None else x.detach().cpu() for x in g]
        losses[run] = loss.item()
        del master, leaves, loss, g
    if (flash_attention.launches_dkv, flash_attention.launches_dq,
            flash_attention_bwd_plain.calls) != (cfg.layers,) * 3:
        raise AssertionError(f"9b: K8a/K8b launches "
                             f"{flash_attention.launches_dkv}/"
                             f"{flash_attention.launches_dq}, plain "
                             f"backward calls "
                             f"{flash_attention_bwd_plain.calls}, want "
                             f"{cfg.layers} each")
    grad_err = 0.0
    for a, b in zip(grads["kernel"], grads["plain"]):
        if a is None:
            continue
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        grad_err = max(grad_err, rel)
    # each leaf's gradient within 1e-3 of its largest entry: f32 backward
    # through 12 layers, card and host summation orders
    loss_err = abs(losses["kernel"] - losses["plain"])
    if grad_err > 1e-3 or loss_err > 1e-4 or \
            not all(torch.isfinite(x).all() for x in grads["kernel"]
                    if x is not None):
        raise AssertionError(f"9b: gradient rel err {grad_err}, loss err "
                             f"{loss_err}")
    rec = {"B": B, "S": S, "dtype": "float32",
           "hidden_kernel_vs_plain": fwd_err,
           "hidden_flash_vs_dense_unpadded_rows": dense_err,
           "loss_kernel": losses["kernel"], "loss_plain": losses["plain"],
           "grad_max_rel_err": grad_err}
    log(f"[flash parity] {json.dumps(rec)} | {dev_info['smi']}")
    del grads
    torch.cuda.empty_cache()
    return rec


def phase_flash_inference(bert_np, dev_info, k7_ms, reps=5):
    """9c: BERT-base encoder inference in bf16, B = 32, S = 512, ragged
    padding masks: 12 K7 launches per forward and no plain call; K7's
    share of a forward from ``k7_ms``, its time at this shape in 9a."""
    import torch
    from mmlspark_tpu_torch.models.zoo import transformer as tf
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    dev = torch.device("cuda")
    cfg = _bert_cfg(torch.bfloat16, use_flash=True)
    params = tf.params_from_numpy(bert_np, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    B, S = 32, 512
    ids = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    mask = _lengths_mask(B, S, gen, dev)
    with torch.no_grad():
        tf.transformer_apply(params, ids, cfg, mask=mask)    # warm-up
        torch.cuda.synchronize()
        flash_attention.launches = 0
        flash_attention_plain.calls = 0
        t0 = time.perf_counter()
        for _ in range(reps):
            h = tf.transformer_apply(params, ids, cfg, mask=mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        plain = flash_attention_plain.calls
        # untimed: the same ids and masks through dense attention (every
        # row keeps >= 64 keys, so both define the same function there)
        hd = tf.transformer_apply(params, ids, cfg._replace(use_flash=False),
                                  mask=mask)
    if launches != cfg.layers * reps or plain != 0:
        raise AssertionError(f"9c: {launches} K7 launches (want "
                             f"{cfg.layers * reps}), {plain} plain calls")
    if h.shape != (B, S, cfg.d_model) or h.dtype != torch.bfloat16 or \
            not torch.isfinite(h).all():
        raise AssertionError(f"9c: hidden {tuple(h.shape)} {h.dtype}, "
                             f"finite {bool(torch.isfinite(h).all())}")
    # bf16 flash against bf16 dense: both round P once (dense after the
    # normalisation, flash before it) and every layer's activations to
    # bf16, and 12 layers carry the differences; 2^-3 of the largest
    # hidden value is 16 to 32 bf16 ulps at its magnitude. A wrong
    # fragment or a skipped live tile moves the hidden states by
    # O(max|h|).
    dense_err = (h.float() - hd.float()).abs().max().item()
    dense_bound = 2.0 ** -3 * hd.float().abs().max().item()
    if not dense_err <= dense_bound:
        raise AssertionError(f"9c: bf16 flash vs dense hidden max |diff| "
                             f"{dense_err} above {dense_bound}")
    ms_fwd = wall / reps * 1e3
    rec = {"B": B, "S": S, "forwards": reps, "wall_s": wall,
           "seq_per_s": B * reps / wall, "ms_per_forward": ms_fwd,
           "real_tokens": int(mask.sum()), "k7_launches": launches,
           "k7_share_of_forward": cfg.layers * k7_ms / ms_fwd,
           "hidden_flash_vs_dense_max_abs": dense_err,
           "hidden_flash_vs_dense_bound": dense_bound}
    log(f"[flash inference] {json.dumps(rec)} | {dev_info['smi']}")
    del params, h, hd
    torch.cuda.empty_cache()
    return rec


def _train_run(params_np, cfg, B, S, steps, lr, seed):
    """``train_step`` ``steps`` times on one fixed batch after one warm-up
    step; returns (losses, per-step seconds, launch counts, plain calls,
    peak bytes). The counts cover the timed steps, or the warm-up step
    itself when ``steps`` is 0."""
    import torch
    from mmlspark_tpu_torch.models.zoo import transformer as tf
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain)
    dev = torch.device("cuda")
    params = tf.params_from_numpy(params_np, cfg, dev, master=True)
    opt = [torch.zeros_like(t) for t in tf.tree_leaves(params)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def zero_counts():
        flash_attention.launches = flash_attention.launches_dkv = 0
        flash_attention.launches_dq = 0
        flash_attention_plain.calls = flash_attention_bwd_plain.calls = 0

    zero_counts()
    losses = [float(tf.train_step(params, opt, ids, labels, cfg, lr=lr)[2])]
    if steps:
        zero_counts()
    secs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(tf.train_step(params, opt, ids, labels, cfg,
                                          lr=lr)[2]))
        secs.append(time.perf_counter() - t0)
    counts = (flash_attention.launches, flash_attention.launches_dkv,
              flash_attention.launches_dq)
    plain = flash_attention_plain.calls + flash_attention_bwd_plain.calls
    peak = torch.cuda.max_memory_allocated()
    del params, opt
    torch.cuda.empty_cache()
    return losses, secs, counts, plain, peak


def phase_flash_training(bert_np, dev_info, kernel_ms, steps=10):
    """9d: BERT-base bf16 training, B = 16, S = 512, ``steps`` steps on one
    fixed batch after a warm-up step (12 launches each of K7, K8a and K8b
    per step, no plain call, the loss finite and lower at the end), and
    the kernels' share of a step from ``kernel_ms``, their summed time at
    this shape in 9a; then one step of the FULL causal decoder at B = 4,
    S = 2048 with flash (12 launches of each kernel) and with dense
    attention (none): flash's peak device memory below dense's."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    cfg = _bert_cfg(torch.bfloat16, use_flash=True)
    B, S = 16, 512
    # lr 1e-3: at the reference's 1e-4, ten steps of random-label training
    # move the loss by ~5e-4, too close to bf16 rounding to assert on
    losses, secs, counts, plain, peak = _train_run(bert_np, cfg, B, S, steps,
                                                   1e-3, 7)
    want = tuple([cfg.layers * steps] * 3)
    if counts != want or plain != 0:
        raise AssertionError(f"9d: K7/K8a/K8b launches {counts} (want "
                             f"{want}), plain calls {plain}")
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[1]:
        raise AssertionError(f"9d: losses {losses}")
    step_s = statistics.median(secs)
    bert = {"B": B, "S": S, "steps": steps, "lr": 1e-3,
            "loss_first": losses[1], "loss_last": losses[-1],
            "step_s_median": step_s, "step_s": secs,
            "tokens_per_s": B * S / step_s, "peak_bytes": peak,
            "k7_launches": counts[0], "k8a_launches": counts[1],
            "k8b_launches": counts[2],
            "flash_share_of_step": cfg.layers * kernel_ms / (step_s * 1e3)}
    log(f"[flash training] {json.dumps(bert)} | {dev_info['smi']}")
    dec_np = init_transformer(_full_cfg(torch.float32), seed=0)
    mem, dcounts = {}, {}
    for use_flash in (True, False):
        dcfg = _full_cfg(torch.bfloat16)._replace(use_flash=use_flash)
        dl, ds, dc, dp, dpeak = _train_run(dec_np, dcfg, 4, 2048, 0, 1e-4, 8)
        want = (dcfg.layers if use_flash else 0,) * 3
        if not np.isfinite(dl[0]) or dc != want or dp != 0:
            raise AssertionError(f"9d decoder (use_flash={use_flash}): loss "
                                 f"{dl}, K7/K8a/K8b launches {dc} (want "
                                 f"{want}), plain calls {dp}")
        mem["flash" if use_flash else "dense"] = dpeak
        dcounts["flash" if use_flash else "dense"] = dc
    if not mem["flash"] < mem["dense"]:
        raise AssertionError(f"9d decoder: flash peak {mem['flash']} not "
                             f"below dense {mem['dense']}")
    dec = {"B": 4, "S": 2048, "launches_flash_step": dcounts["flash"],
           "peak_bytes_flash": mem["flash"],
           "peak_bytes_dense": mem["dense"],
           "flash_over_dense": mem["flash"] / mem["dense"]}
    log(f"[flash decoder memory] {json.dumps(dec)} | {dev_info['smi']}")
    return bert, dec


def _kernel_launches(fn):
    """What one call of ``fn`` asks of the card, by ``torch.profiler``:
    (kernel launches the runtime saw, as ``serving/tick_profile.py``
    counts them; memset and copy calls; the device activity recorded).
    The runtime calls are the count: a second profiler session in one
    process may record no device activity at all."""
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # "Profiler clears events at the end of each cycle": one cycle here
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if "LaunchKernel" in e.key)
    copies = sum(e.count for e in ev
                 if "Memset" in e.key or "Memcpy" in e.key)
    device = [e.key for e in ev if str(e.device_type).endswith("CUDA")
              for _ in range(e.count)]
    return launches, copies, device


def _bodies(kind=""):
    """Launches by the body the library reported: K1/K2 (``kind=""``) or
    K5a/K5b (``kind="window"``) on the tensor-core (``mma``, K1 or K5a /
    ``q_mma``, K2 or K5b) and split decode bodies (``split``,
    ``q_split``); K3/K4 (``kind="read"``) on the split body (``split``,
    ``q_split``)."""
    from mmlspark_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_window)
    if kind == "read":
        return {k: getattr(paged_attention, "launches_" + k)
                for k in ("split", "q_split")}
    pre = "launches_" + (kind + "_" if kind else "")
    return {k: getattr(paged_attention_window, pre + k)
            for k in ("mma", "q_mma", "split", "q_split")}


def _body_ran(b0, b1, quant):
    """The body one call ran, from :func:`_bodies` before (``b0``) and
    after (``b1``): "split", "mma", or "fma" with the counters that
    moved."""
    ran = {k for k in b1 if b1[k] > b0[k]}
    q = "q_" if quant else ""
    return ("split" if ran == {q + "split"} else
            "mma" if ran == {q + "mma"} else f"fma {ran}")


def _window_case(dev_info, label, B, W, pos_list, active_list, seed,
                 store=None, H=12, P=None):
    """The window read at one shape: K5a over bf16 pages, or K5b over
    quantized pages of ``store`` dtype, ``H`` heads, bf16 queries.
    Correctness against the plain version (ctx within about one bf16 ulp,
    plus 2**-8 * R for the tensor-core body at W > 1; the NaN planted at
    and past each row's pos kept out, every pool bit untouched), the body
    the library reports (split at W = 1, tensor-core at W > 1) and one
    call = one kernel on the card; then its time, the plain version's,
    one SDPA over the gathered dequantized K/V and the window (the
    library yardstick), its bound, the wrapper's host-paced time, and on
    their own the rows the mesh path writes after it (``_mount_writes``)."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    x = _kv_case_inputs(B, W, pos_list, seed, store, H=H, P=P)
    hd, page, P = x["hd"], x["page"], x["P"]
    q, kn, vn, bt, pools = x["q"], x["kn"], x["vn"], x["bt"], x["pools"]
    pos_np = x["pos_np"]
    quant = store is not None
    what = (f"K5b {str(store).split('.')[-1]} {label}" if quant
            else f"K5a {label}")
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    active = torch.tensor(active_list, device=dev)
    scale = 1.0 / hd ** 0.5
    want = pa.paged_attention_window_read_plain(q, kn, vn, pools[0],
                                                pools[1], bt, pos, scale,
                                                *pools[2:])
    # W > 1 runs the tensor-core body: its bound adds 2**-8 * R
    r = pa.paged_rounding_scale(q, kn, vn, pools[0], pools[1], bt, pos,
                                scale, *pools[2:]) if W > 1 else None
    kern = [t.clone() for t in pools]
    b0 = _bodies("window")
    got = pa._window_read(q, kn, vn, kern[0], kern[1], bt, pos, scale,
                          *kern[2:])
    torch.cuda.synchronize()
    body = _body_ran(b0, _bodies("window"), quant)
    if body != ("split" if W == 1 else "mma"):
        raise AssertionError(f"{what}: ran the {body} body")
    err = _check_ctx(what, got, want, r)
    if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(kern, pools)):
        raise AssertionError(f"{what}: the window read wrote its pools")
    # one call is one kernel on the card (the split body's workspace is
    # cached: no memset, no second launch)
    launches, memsets, device = _kernel_launches(lambda: pa._window_read(
        q, kn, vn, kern[0], kern[1], bt, pos, scale, *kern[2:]))
    if launches != 1 or memsets or len(device) > 1:
        raise AssertionError(f"{what}: one call ran {launches} launches "
                             f"and {memsets} memsets / copies; device "
                             f"activity {device}")
    lib = pa._library()
    n = _copies(sum(t.numel() * t.element_size() for t in pools))
    copies = [[t.clone() for t in kern] for _ in range(n)]
    stream = torch.cuda.current_stream().cuda_stream
    acts = (q.data_ptr(), kn.data_ptr(), vn.data_ptr())
    tail = (B, H, W, P, page, scale, stream)
    work = (None, None)
    if W == 1:
        work = tuple(t.data_ptr() for t in pa._split_workspace(
            q.device, B, H, P, page, hd, lib.split_chunk))
    rc = []

    def launcher(c):
        ptrs = [t.data_ptr() for t in c]
        ints = (bt.data_ptr(), pos.data_ptr(), got.data_ptr(), *work)
        if quant:
            return lambda: rc.append(lib.mmlspark_pa_window_read_q(
                1, pa._STORES[store], hd, *acts, *ptrs, *ints, *tail, None))
        return lambda: rc.append(lib.mmlspark_pa_window_read(
            1, hd, *acts, *ptrs, *ints, *tail, None))

    wrapped = [lambda c=c: pa._window_read(q, kn, vn, c[0], c[1], bt, pos,
                                           scale, *c[2:]) for c in copies]
    raw = [launcher(c) for c in copies]
    # warm-up, untimed (and past the profiler)
    _cuda_ms(raw + wrapped, len(raw) + len(wrapped), head_start=False)
    # the kernel back to back (device time), the wrapper paced by the
    # host, and the wrapper's host cost alone
    ms = _cuda_ms(raw, 200)
    host_paced = _cuda_ms(wrapped, 200, head_start=False)
    host_ms = _host_ms(wrapped, 200)
    if any(rc):
        raise AssertionError(f"{what}: launch returned {set(rc)}")
    plain_ms = _cuda_ms([lambda c=c: pa.paged_attention_window_read_plain(
        q, kn, vn, c[0], c[1], bt, pos, scale, *c[2:]) for c in copies], 20)

    write_ms = _cuda_ms([lambda c=c: pa._mount_writes(kn, vn, c, bt, pos,
                                                      active)
                         for c in copies], 200)
    del copies
    L = P * page
    key_ok = x["t_idx"][None] < pos.long()[:, None]
    kc, vc = _dequant_kv(pools, bt, key_ok)
    k_all = torch.cat([kc, kn], 2).contiguous()
    v_all = torch.cat([vc, vn], 2).contiguous()
    causal = torch.tril(torch.ones(W, W, dtype=torch.bool, device=dev))
    mask = torch.cat([key_ok[:, None, None, :].expand(B, 1, W, L),
                      causal[None, None].expand(B, 1, W, W)], -1)
    n = _copies(2 * k_all.numel() * k_all.element_size())
    kvs = [(k_all.clone(), v_all.clone()) for _ in range(n)]
    sdpa = [lambda c=c: F.scaled_dot_product_attention(
        q, c[0], c[1], attn_mask=mask) for c in kvs]
    library_ms = _cuda_ms(sdpa, 200)
    library_host = _cuda_ms(sdpa, 200, head_start=False)
    del kvs, sdpa
    # bound: K1's less the window-row writes — live cached keys (< pos)
    # with their scales, q/k_new/v_new, ctx; flops QK and PV over live
    # keys and the window. The writes' own bound: k_new/v_new read, the
    # active rows' codes (and scales) written.
    row_bytes = hd + 2 if quant else 2 * hd
    live = int(pos_np.sum())
    n_active = int(sum(active_list))
    nbytes = (2 * live * H * row_bytes + 3 * B * H * W * hd * 2
              + B * H * W * hd * 2 + bt.numel() * 4 + B * 4)
    flops = sum(4 * H * hd * W * (int(p) + W) for p in pos_np)
    wbytes = (2 * B * H * W * hd * 2 + 2 * n_active * W * H * row_bytes
              + bt.numel() * 4 + B * 4)
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **_bound(dev_info, nbytes, flops), "library_ms": library_ms,
           "library_ms_host_paced": library_host,
           "window_read_ms_host_paced": host_paced,
           "window_read_host_ms": host_ms,
           "body": body, "launches_per_call": launches,
           "write_ms": write_ms,
           "write_bound_ms": _bound(dev_info, wbytes, 0)["bound_ms"],
           "shape": {"B": B, "H": H, "W": W, "hd": hd, "page": page, "P": P,
                     "max_pos": int(pos_np.max()), "live_keys": live,
                     "pages": str(store or torch.bfloat16).split(".")[-1]}}
    tag = what.split()[0].lower() + " " + " ".join(what.split()[1:])
    log(f"[{tag}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def window_cases():
    """10a's cases, ``(kernel, label, args, keywords)`` for
    :func:`_window_case` (and ``time_window_read.py``): K5a on bf16 pages
    and K5b on int8 and fp8 pages at phase 3's decode and extend shapes
    (12 heads), the decode shape on 6 heads (one rank's shard at tp = 2),
    serving's own decode (16 rows up to 10c's 448 keys over its 64-page
    block table) and a straggler (one row at 2047, the rest at 64 or
    below: continuous batching with one long context)."""
    import torch
    pos, active, serve, straggler = _decode_rows()
    shapes = {"decode": ((16, 1, pos, active), {}),
              "extend": ((1, 256, [384], [True]), {}),
              "decode h6": ((16, 1, pos, active), {"H": 6}),
              "serving decode": ((16, 1, serve, active), {"P": 64}),
              "straggler": ((16, 1, straggler, active), {})}
    cases, seed = [], 5
    for store in (None, torch.int8, torch.float8_e4m3fn):
        name = "" if store is None else str(store).split(".")[-1] + " "
        for label, (args, kw) in shapes.items():
            cases.append(("K5a" if store is None else "K5b", name + label,
                          (label, *args, seed), {"store": store, **kw}))
            seed += 1
    return cases


def phase_window_kernels(dev_info):
    """10a: every case of :func:`window_cases`."""
    recs = {"K5a": {}, "K5b": {}}
    for kernel, name, args, kw in window_cases():
        recs[kernel][name] = _window_case(dev_info, *args, **kw)
    return recs


def _zero_pa_counts():
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    for name in ("", "_q", "_mma", "_q_mma", "_split", "_q_split",
                 "_window", "_window_q", "_window_mma", "_window_q_mma",
                 "_window_split", "_window_q_split"):
        setattr(paged_attention_window, "launches" + name, 0)


def _pa_counts():
    """(K1, K2, K5a, K5b) launches since the last zeroing."""
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    p = paged_attention_window
    return (p.launches, p.launches_q, p.launches_window,
            p.launches_window_q)


def phase_mesh_parity(params_np, single, mesh):
    """10b: f32 full width on a tp = 1 mesh (a world of one rank over
    NCCL): the meshed kernel engine's greedy tokens equal the single-device
    kernel engine's (phase 4's) and the meshed gather engine's, on f32,
    int8 and fp8 pages; K5a (f32) or K5b (int8, fp8) launched, K1 and K2
    never, the decode steps through the split body (f32 queries: none on
    the tensor-core body). Returns the launches per page type."""
    import torch
    cfg = _full_cfg(torch.float32)
    launches = {}
    for kv_dtype in (None, "int8", "fp8"):
        outs, counts = {}, {}
        for impl in ("kernel", "gather"):
            _zero_pa_counts()
            outs[impl] = _parity_tokens(params_np, cfg, impl, kv_dtype,
                                        mesh)[0]
            counts[impl] = _pa_counts()
            if impl == "kernel":
                bodies = _bodies("window")
        name = kv_dtype or "f32"
        if not outs["kernel"] == single[kv_dtype] == outs["gather"]:
            raise AssertionError(
                f"10b {name} pages: meshed kernel {outs['kernel']}, single "
                f"device {single[kv_dtype]}, meshed gather {outs['gather']}")
        k1, k2, k5a, k5b = counts["kernel"]
        want = (k5a > 0 and k5b == 0) if kv_dtype is None else \
            (k5b > 0 and k5a == 0)
        split = bodies["split"] + bodies["q_split"]
        mma = bodies["mma"] + bodies["q_mma"]
        if k1 or k2 or not want or any(counts["gather"]) or mma or \
                not 0 < split < k5a + k5b:
            raise AssertionError(f"10b {name} pages: (K1, K2, K5a, K5b) "
                                 f"launches {counts}, bodies {bodies}")
        launches[name] = {"k5a": k5a, "k5b": k5b, "split": split}
        log(f"[mesh parity] f32 full width, tp1 mesh, {name} pages: meshed "
            f"kernel == single-device kernel == meshed gather for "
            f"{len(PARITY_PROMPTS)} requests x {PARITY_NEW} tokens; K5a "
            f"{k5a}, K5b {k5b} ({split} on the split body), K1/K2 0")
    return launches


def _serve_mix(eng, rng, vocab, sizes, max_new):
    """Phase 6's request mix through ``submit``/``step``: two requests
    sharing a 96-token prefix (the owner first), then prompts of
    ``sizes``; returns (requests, wall seconds)."""
    import numpy as np
    import torch
    shared = rng.integers(0, vocab, 96)
    t0 = time.perf_counter()
    reqs = [eng.submit(np.concatenate([shared,
                                       rng.integers(0, vocab, tail)]),
                       max_new, prefix_key="system", prefix_len=len(shared))
            for tail in (8, 24)]
    reqs += [eng.submit(rng.integers(0, vocab, n), max_new) for n in sizes]
    while not all(r.done for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def phase_mesh_serving(params_np, dev_info, mesh, q8, write_ms):
    """10c: bf16 full width, phase 6's mix (64 new tokens each) through a
    single-device engine and then a tp = 1 meshed engine, bf16 pages.
    The meshed run must launch K5a once per layer per attention call
    (decode step or extend) and no K1/K2 (the single-device run K1 and
    nothing else), gather nothing and hit the prefix; each run's launches
    split by body as phases 5 and 6 split K1's and K2's: the tensor-core
    ones exactly the engine's prefill chunks and prefix suffixes times
    the layers, the split ones the rest (the decode steps); tokens/s and
    p50 tick beside the single-device bf16 run and phase 6's int8
    numbers. Then one all-reduce of a decode step's (16, 1, d_model)
    activations on the mesh's group is timed, and with 10a's time of the
    rows written outside the kernel (``write_ms``) gives the mesh's added
    time per tick: layers x steps x (writes + two all-reduces)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from mmlspark_tpu_torch.parallel.mesh import axis_group
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    from mmlspark_tpu_torch.utils.device import resolve_device
    cfg = _full_cfg(torch.bfloat16)
    sizes, max_new = [32, 128, 384] * 3, 64
    out = {}
    for key, m in (("single", None), ("mesh", mesh)):
        eng = ContinuousDecoder(params_np, cfg, max_slots=16, max_len=1024,
                                page_size=16, prefill_chunk=256,
                                steps_per_dispatch=4, mesh=m)
        warm = eng.submit([1, 2, 3], 4)     # cuBLAS handles, allocator
        while not warm.done:
            eng.step()
        eng.tick_seconds.clear()
        stats0, hits0 = dict(eng._kv.stats), eng.stats["prefix_hits"]
        chunks0 = len(eng._chunk_trace)
        _zero_pa_counts()
        reqs, wall = _serve_mix(eng, np.random.default_rng(3), cfg.vocab,
                                sizes, max_new)
        counts = _pa_counts()
        bodies = _bodies("window" if m is not None else "")
        chunks = len(eng._chunk_trace) - chunks0
        stats = eng._kv.stats
        calls = stats["attn_ticks_kernel"] - stats0["attn_ticks_kernel"]
        gather = stats["gather_bytes"] - stats0["gather_bytes"]
        for r in reqs:
            toks = eng.result(r, timeout=1)
            if len(toks) != max_new or not all(0 <= t < cfg.vocab
                                               for t in toks):
                raise AssertionError(f"10c {key} request {r.rid}: "
                                     f"{len(toks)} tokens")
        hits = eng.stats["prefix_hits"] - hits0
        want = ((cfg.layers * calls, 0, 0, 0) if key == "single"
                else (0, 0, cfg.layers * calls, 0))
        if counts != want or gather != 0 or hits < 1:
            raise AssertionError(f"10c {key}: (K1, K2, K5a, K5b) launches "
                                 f"{counts}, want {want}; gather {gather}, "
                                 f"prefix hits {hits}")
        ticks = list(eng.tick_seconds)
        n_tok = sum(len(r.tokens) for r in reqs)
        out[key] = {"requests": len(reqs), "tokens": n_tok, "wall_s": wall,
                    "tok_per_s": n_tok / wall,
                    "p50_tick_ms": statistics.median(ticks) * 1e3,
                    "ticks": len(ticks), "attn_calls": calls,
                    "k1_launches": counts[0], "k5a_launches": counts[2],
                    "prefill_chunks": chunks, "prefix_hits": hits,
                    "mesh_shape": eng._mesh_shape,
                    "pool_device_bytes": eng._kv.device_bytes()}
        what, i = ("K5a", 2) if key == "mesh" else ("K1", 0)
        split = _window_split(what, counts[i], bodies, calls, chunks, hits,
                              cfg.layers)
        out[key].update({f"{what.lower()}_launches_decode": split["decode"],
                         f"{what.lower()}_launches_extend": split["extend"]})
        del eng
        torch.cuda.empty_cache()
    x = torch.zeros(16, 1, cfg.d_model, dtype=cfg.dtype,
                    device=resolve_device())
    group = axis_group(mesh, "tp")
    allreduce_ms = _cuda_ms([lambda: dist.all_reduce(x, group=group)], 200)
    added = cfg.layers * 4 * (write_ms + 2 * allreduce_ms)
    rec = {**out, "phase6_int8_single": {k: q8[k] for k in
                                         ("tok_per_s", "p50_tick_ms")},
           "allreduce_ms": allreduce_ms, "write_ms": write_ms,
           "added_ms_per_tick_from_parts": added,
           "added_ms_per_tick_measured": (out["mesh"]["p50_tick_ms"]
                                          - out["single"]["p50_tick_ms"]),
           "steps_per_dispatch": 4, "layers": cfg.layers}
    log(f"[mesh serving] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _tp2_rank(mesh, seed):
    """One rank of 10d: the f32 full-width model from ``seed``, this
    rank's six heads, a pool shard, the parity prompts; its tokens, its
    (K1, K2, K5a, K5b) launches and its shard's bytes."""
    import torch
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    from mmlspark_tpu_torch.parallel.mesh import axis_rank
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _full_cfg(torch.float32)
    params_np = init_transformer(cfg, seed=seed)
    eng = ContinuousDecoder(params_np, cfg, mesh=mesh, **PARITY)
    _zero_pa_counts()
    reqs = [eng.submit(p, PARITY_NEW) for p in _parity_prompts(cfg.vocab)]
    for _ in range(400):
        if all(r.done for r in reqs):
            break
        eng.step()
    eng.flush()
    return {"rank": axis_rank(mesh, "tp"), "mesh_shape": eng._mesh_shape,
            "tokens": [eng.result(r, timeout=1) for r in reqs],
            "launches": _pa_counts(), "bodies": _bodies("window"),
            "pool_heads": eng._kv.heads,
            "pool_device_bytes": eng._kv.device_bytes(),
            "pool_device_bytes_global": eng._kv.device_bytes_global()}


def phase_tp2(dev_info, want):
    """10d: tp = 2 on the one card — two rank processes over gloo, each
    with six heads and its own pool shard, the f32 parity engine: both
    ranks' tokens equal each other's and 10b's over all
    ``PARITY_NEW`` tokens; K5a launched on each rank, its decode steps on
    the split body, K1/K2 never."""
    from mmlspark_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    res = run_ranks(_tp2_rank, 2, args=(0,), device="cuda", timeout=600)
    wall = time.perf_counter() - t0
    for r in res:
        k1, k2, k5a, k5b = r["launches"]
        split, mma = r["bodies"]["split"], r["bodies"]["mma"]
        if r["tokens"] != want or r["mesh_shape"] != "tp2" or \
                r["pool_heads"] != 6 or k1 or k2 or k5b or mma or \
                not 0 < split < k5a:
            raise AssertionError(f"10d rank {r['rank']}: tokens "
                                 f"{r['tokens']} (want {want}), launches "
                                 f"{r['launches']}, bodies {r['bodies']}, "
                                 f"heads {r['pool_heads']}")
    rec = {"ranks": 2, "backend": "gloo", "horizon_tokens": PARITY_NEW,
           "k5a_launches_per_rank": [r["launches"][2] for r in res],
           "k5a_launches_split_per_rank": [r["bodies"]["split"]
                                           for r in res],
           "pool_device_bytes_per_rank": res[0]["pool_device_bytes"],
           "pool_device_bytes_global": res[0]["pool_device_bytes_global"],
           "wall_s": wall}
    log(f"[tp2] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


# bench.py's headline configuration (bench.py:1138-1175): ResNet-50 from
# export_resnet_onnx(RESNET50, seed=0), 2048 uint8 224x224x3 NHWC rows in
# an object column, batch 512, bfloat16, ImageNet normalization on device
ONNX_BENCH = dict(rows=2048, batch=512, passes=3, parity_rows=32,
                  cpu_rows=4)
IMAGENET = {"scale": 1.0 / 255.0, "mean": [0.485, 0.456, 0.406],
            "std": [0.229, 0.224, 0.225]}


def _onnx_model(model_bytes, dtype, batch, device=None, **kw):
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    return ONNXModel(model_bytes, device=device,
                     feed_dict={"input": "image"},
                     fetch_dict={"logits": "logits"},
                     argmax_dict={"pred": "logits"},
                     transpose_dict={"input": [0, 3, 1, 2]},
                     normalize_dict={"input": IMAGENET},
                     mini_batch_size=batch, compute_dtype=dtype, **kw)


def _graph_flops_per_image(m, x1):
    """FLOPs of one image through the converted graph, counted from its
    Conv and Gemm shapes (2 per multiply-add): the graph runs once on a
    batch of one and every node's output shape is read from its
    environment."""
    import torch
    from mmlspark_tpu_torch.onnx.convert import _Ctx, _eval_nodes
    cm = m._ensure_converted()
    params = m._params_for_device(x1.device)
    env = dict(cm.const_params)
    env.update(params)
    env["input"] = x1
    env[""] = None
    with torch.inference_mode():
        _eval_nodes(cm.model.graph.nodes, env, _Ctx(cm.model.opset,
                                                     x1.device))
    flops = 0
    for node in cm.model.graph.nodes:
        if node.op_type == "Conv":
            w = env[node.input[1]]
            flops += 2 * env[node.output[0]].numel() * w[0].numel()
        elif node.op_type == "Gemm":
            a, b = env[node.input[0]], env[node.input[1]]
            k = a.shape[-1] if not node.attr("transA", 0) else a.shape[-2]
            flops += 2 * env[node.output[0]].numel() * k
    return flops


def phase_onnx(dev_info):
    """11a-11c: batched ONNX inference of ResNet-50 through
    ``DataFrame`` → ``ONNXModel.transform`` (no hand kernel on this
    path: convs are cuDNN, the head is cuBLAS)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.zoo.resnet import (RESNET50, ResNetConfig,
                                                      init_resnet,
                                                      resnet_apply)
    dev = torch.device("cuda")
    cfg = ONNX_BENCH
    model_bytes, export_s = _resnet50_onnx()
    X = np.random.default_rng(0).integers(0, 256, (cfg["rows"], 224, 224, 3),
                                          dtype=np.uint8)
    n32 = cfg["parity_rows"]

    # 11a: f32 at full width (TF32 off since phase 1): the ONNX path on the
    # card, resnet_apply on the card with the same params, and the ONNX
    # path on the CPU over the first 4 rows. Tolerance: 1e-3 of the
    # largest |logit| (f32 sum order over ResNet-50's 53 convs and the
    # head; a wrong layout, pad or fold moves logits by O(max|logit|)).
    f32 = _onnx_model(model_bytes, "float32", n32)
    card = f32.transform(DataFrame({"image": X[:n32]}))["logits"]
    with torch.inference_mode():
        xf = torch.from_numpy(X[:n32]).to(dev).float()
        mean = torch.tensor(IMAGENET["mean"], device=dev)
        std = torch.tensor(IMAGENET["std"], device=dev)
        xf = (xf * torch.tensor(IMAGENET["scale"], device=dev) - mean) / std
        native = resnet_apply(init_resnet(RESNET50, seed=0), xf,
                              ResNetConfig([3, 4, 6, 3],
                                           dtype=torch.float32)
                              ).cpu().numpy()
    ncpu = cfg["cpu_rows"]
    cpu = _onnx_model(model_bytes, "float32", ncpu, device="cpu").transform(
        DataFrame({"image": X[:ncpu]}))["logits"]
    tol = 1e-3 * float(np.abs(card).max())
    err_native = float(np.abs(card - native).max())
    err_cpu = float(np.abs(card[:ncpu] - cpu).max())
    if card.shape != (n32, 1000) or not np.isfinite(card).all():
        raise AssertionError(f"11a: logits {card.shape}, finite "
                             f"{bool(np.isfinite(card).all())}")
    if not (err_native <= tol and err_cpu <= tol):
        raise AssertionError(f"11a: f32 logits off: vs resnet_apply "
                             f"{err_native}, vs CPU {err_cpu}, bound {tol}")
    if not ((card.argmax(1) == native.argmax(1)).all()
            and (card[:ncpu].argmax(1) == cpu.argmax(1)).all()):
        raise AssertionError("11a: f32 argmax differs between the card's "
                             "ONNX path, resnet_apply and the CPU")
    parity = {"rows": n32, "cpu_rows": ncpu, "bound": tol,
              "max_abs_vs_resnet_apply": err_native,
              "max_abs_vs_cpu": err_cpu, "max_abs_logit": float(
                  np.abs(card).max()),
              "distinct_argmax": int(len(set(card.argmax(1).tolist())))}
    log(f"[onnx 11a] {json.dumps(parity)}")
    del f32

    # 11b: bench.py's configuration, host-fed: warm-up over the buckets
    # the run hits, then timed passes, with cuDNN choosing algorithms per
    # shape during the warm-up (benchmark mode, as XLA autotunes)
    torch.backends.cudnn.benchmark = True
    col = np.empty(cfg["rows"], dtype=object)
    for i in range(cfg["rows"]):
        col[i] = X[i]
    df = DataFrame({"image": col})
    batch = cfg["batch"]
    m = _onnx_model(model_bytes, "bfloat16", batch)
    warm_sizes = sorted({batch, cfg["rows"] % batch or batch})
    warm = m.warm_up(batch_sizes=warm_sizes,
                     input_specs={"input": (np.uint8, (224, 224, 3))})
    m.transform(df.head(batch))                  # one untimed trip
    torch.cuda.synchronize()
    m.stage_counters.reset()
    passes, out = [], None
    for _ in range(cfg["passes"]):
        t0 = time.perf_counter()
        out = m.transform(df)
        passes.append(time.perf_counter() - t0)
    stages = m.stage_counters.snapshot()
    ips = [cfg["rows"] / p for p in passes]
    logits_b, pred_b = out["logits"], out["pred"]
    if logits_b.shape != (cfg["rows"], 1000) or \
            not np.isfinite(logits_b).all():
        raise AssertionError(f"11b: logits {logits_b.shape}, finite "
                             f"{bool(np.isfinite(logits_b).all())}")
    # bf16 against 11a's f32 on the first 32 rows: 53 bf16 convs round
    # activations once each (2^-9 relative), so the logits stay within
    # 2^-4 of the largest f32 |logit|; argmax equal wherever f32's
    # top-two gap exceeds that bound
    bf_bound = 2.0 ** -4 * float(np.abs(card).max())
    bf_err = float(np.abs(logits_b[:n32] - card).max())
    top2 = np.sort(card, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > bf_bound
    if not bf_err <= bf_bound:
        raise AssertionError(f"11b: bf16 vs f32 logits {bf_err} above "
                             f"{bf_bound}")
    if not (pred_b[:n32][clear] == card.argmax(1)[clear]).all():
        raise AssertionError("11b: bf16 argmax differs from f32 on a row "
                             "whose top-two gap exceeds the bound")

    # the converted graph alone on a resident batch of 512: the whole
    # batch function (prep + graph + argmax) on uint8, then the graph on
    # its prepped bf16 input channels-last and contiguous NCHW
    fn = m._ensure_fn()
    params = m._params_for_device(dev)
    cm = m._ensure_converted()
    x512 = torch.from_numpy(X[:batch]).to(dev)
    with torch.inference_mode():
        xin = x512.permute(0, 3, 1, 2).to(torch.bfloat16)
        xin = xin * torch.tensor(IMAGENET["scale"], dtype=torch.bfloat16)
        xin = (xin - torch.tensor(IMAGENET["mean"], device=dev).to(
            torch.bfloat16).reshape(1, -1, 1, 1)) / torch.tensor(
            IMAGENET["std"], device=dev).to(torch.bfloat16).reshape(
            1, -1, 1, 1)
        if not xin.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError("11b: the permuted uint8 batch is not "
                                 "channels-last")
        flops_img = _graph_flops_per_image(m, xin[:1])
        nchw_params = {k: v.contiguous() for k, v in params.items()}
        xin_nchw = xin.contiguous()
        calls = {
            "batch_fn_channels_last": lambda: fn(params, {"input": x512}),
            "graph_channels_last": lambda: cm(params, {"input": xin}),
            "graph_nchw": lambda: cm(nchw_params, {"input": xin_nchw})}
        for f in calls.values():
            f()                  # cuDNN picks each layout's algorithms
        torch.cuda.synchronize()
        # interleaved, as the measuring guide asks of two versions
        dev_ms = {k: [] for k in calls}
        for _ in range(2):
            for k, f in calls.items():
                dev_ms[k].append(_cuda_ms([f], 10))
        host_ms = {k: _host_ms([f], 5) for k, f in calls.items()}
    dev_ms = {k: statistics.median(v) for k, v in dev_ms.items()}
    peak = dev_info["flops"]
    host_fed = {
        "rows": cfg["rows"], "batch": batch, "dtype": "bfloat16",
        "export_s": export_s, "warm_up": warm,
        "pass_s": passes, "images_per_s_passes": ips,
        "images_per_s": statistics.median(ips),
        "stage_seconds": {k: v["seconds"] for k, v in stages.items()},
        "stage_bytes": {k: v["bytes"] for k, v in stages.items()
                        if v["bytes"]},
        "flops_per_image": flops_img,
        "peak_share": statistics.median(ips) * flops_img / peak,
        "graph_device_ms": dev_ms, "graph_host_ms": host_ms,
        "graph_images_per_s": {k: batch / v * 1e3
                               for k, v in dev_ms.items()},
        "graph_peak_share": {k: batch * flops_img / (v * 1e-3) / peak
                             for k, v in dev_ms.items()},
        "bf16_vs_f32": {"rows": n32, "max_abs": bf_err, "bound": bf_bound,
                        "argmax_rows_compared": int(clear.sum()),
                        "argmax_equal_rows": int(
                            (pred_b[:n32] == card.argmax(1)).sum()),
                        "max_abs_logit_f32": float(np.abs(card).max())}}
    log(f"[onnx 11b] {json.dumps(host_fed)} | {dev_info['smi']}")

    # 11c: the same rows as a resident column, outputs kept on the card:
    # zero h2d bytes in the runner, outputs bitwise 11b's
    m.set(output_device=True)
    resident = DataFrame({"image": X}).device_put(["image"])
    torch.cuda.synchronize()
    m.transform(resident.head(batch))
    torch.cuda.synchronize()
    m.stage_counters.reset()
    rpasses = []
    for _ in range(cfg["passes"]):
        t0 = time.perf_counter()
        rout = m.transform(resident)
        torch.cuda.synchronize()
        rpasses.append(time.perf_counter() - t0)
    rstages = m.stage_counters.snapshot()
    if rstages["h2d"]["bytes"] != 0:
        raise AssertionError(f"11c: {rstages['h2d']['bytes']} h2d bytes "
                             f"on the resident feed")
    if set(rout.resident_columns) != {"image", "logits", "pred"}:
        raise AssertionError(f"11c: resident {rout.resident_columns}")
    back = rout.to_host()
    if not (np.array_equal(back["logits"], logits_b)
            and np.array_equal(back["pred"].astype(np.int64), pred_b)):
        raise AssertionError(
            f"11c: resident outputs differ from 11b's: max |diff| "
            f"{float(np.abs(back['logits'] - logits_b).max())}")
    rips = [cfg["rows"] / p for p in rpasses]
    res = {"pass_s": rpasses, "images_per_s_passes": rips,
           "images_per_s": statistics.median(rips),
           "peak_share": statistics.median(rips) * flops_img / peak,
           "stage_seconds": {k: v["seconds"] for k, v in rstages.items()},
           "h2d_bytes": rstages["h2d"]["bytes"]}
    log(f"[onnx 11c] {json.dumps(res)} | {dev_info['smi']}")
    torch.backends.cudnn.benchmark = False
    del m, resident, rout, params, nchw_params, x512, xin, xin_nchw
    torch.cuda.empty_cache()
    return {"parity_f32": parity, "host_fed": host_fed, "resident": res}


# ---- phase 14: an ORT-optimized BERT-base through ONNXModel (K7) -----------

#: BERT-base at the published widths (Devlin et al. 2018, the
#: bert-base-uncased config) as the port's ``BertOnnxConfig``
BERT_ONNX = dict(vocab=30522, layers=12, d_model=768, heads=12, d_ff=3072,
                 max_len=512)
#: 14a/14b: 256 right-padded rows of 512 ids, lengths 32 ... 512 from a
#: seeded generator, batches of 32 (the K7 "infer" shape); 4 rows on the CPU
ONNX_BERT = dict(rows=256, seq=512, batch=32, passes=3, cpu_rows=4, seed=14)
#: 14d: ViT-B/16 (224 px, patch 16, d 768, 12 heads, 12 layers, d_ff 3072,
#: 1000 classes), 8 rows; FULL's decoder, 8 decode steps of 2 rows
VIT_B16 = dict(image_size=224, patch=16, d_model=768, heads=12, layers=12,
               d_ff=3072, num_classes=1000)


def fused_bert_onnx(cfg, params, pooled=False, head=None):
    """The ORT-optimized form of ``export_bert_onnx``'s encoder, written with
    the port's builder from the same params (``init_bert_params``):
    ``EmbedLayerNormalization`` (word + position embeddings, LayerNorm,
    ``mask_index`` = the mask's row sums), then per layer ``Attention``
    (com.microsoft: packed q/k/v weights and bias, ``mask_index``), the out
    projection's ``MatMul``, ``SkipLayerNormalization`` (with the out
    projection's bias), ``MatMul``, ``BiasGelu``, ``MatMul``,
    ``SkipLayerNormalization``; output ``last_hidden_state``. Epsilon 1e-5
    and erf-GELU, so it computes the same network as ``export_bert_onnx``;
    no segment embedding (those inputs are empty, as ORT allows).
    ``pooled=True`` adds the sentence embedding a serving graph answers
    with, ``cls`` = ``last_hidden_state[:, 0, :]`` (a ``Gather``).
    ``head=(w, b)`` ((d, C), (C,)) makes it a classifier to fine-tune: the
    CLS row through ``MatMul`` + ``Add`` is ``logits``, and a
    ``SoftmaxCrossEntropyLoss`` against the ``labels`` input (int64,
    (batch,)) is the graph-carried mean ``loss``; the outputs are then
    ``logits`` and ``loss``."""
    import numpy as np
    from mmlspark_tpu_torch.onnx.builder import (make_graph, make_model,
                                                 make_node,
                                                 make_tensor_value_info)
    ms = {"domain": "com.microsoft"}
    inits = {k: params[k] for k in ("embed.word", "embed.pos", "embed.ln.g",
                                    "embed.ln.b")}
    nodes = [make_node("EmbedLayerNormalization",
                       ["input_ids", "", "embed.word", "embed.pos", "",
                        "embed.ln.g", "embed.ln.b", "attention_mask"],
                       ["x0", "mask_index"], epsilon=1e-5, **ms)]
    x = "x0"
    for i in range(cfg.layers):
        p = f"l{i}."
        inits[p + "qkv.w"] = np.concatenate(
            [params[p + n + ".w"] for n in "qkv"], axis=1)
        inits[p + "qkv.b"] = np.concatenate(
            [params[p + n + ".b"] for n in "qkv"])
        for k in ("o.w", "o.b", "ln1.g", "ln1.b", "ff1.w", "ff1.b", "ff2.w",
                  "ff2.b", "ln2.g", "ln2.b"):
            inits[p + k] = params[p + k]
        nodes += [
            make_node("Attention", [x, p + "qkv.w", p + "qkv.b",
                                    "mask_index"], [p + "ctx"],
                      num_heads=cfg.heads, **ms),
            make_node("MatMul", [p + "ctx", p + "o.w"], [p + "o"]),
            make_node("SkipLayerNormalization",
                      [p + "o", x, p + "ln1.g", p + "ln1.b", p + "o.b"],
                      [p + "h"], epsilon=1e-5, **ms),
            make_node("MatMul", [p + "h", p + "ff1.w"], [p + "f1"]),
            make_node("BiasGelu", [p + "f1", p + "ff1.b"], [p + "g"], **ms),
            make_node("MatMul", [p + "g", p + "ff2.w"], [p + "f2"]),
            make_node("SkipLayerNormalization",
                      [p + "f2", p + "h", p + "ln2.g", p + "ln2.b",
                       p + "ff2.b"], [f"x{i + 1}"], epsilon=1e-5, **ms)]
        x = f"x{i + 1}"
    nodes.append(make_node("Identity", [x], ["last_hidden_state"]))
    outputs = [make_tensor_value_info("last_hidden_state", np.float32,
                                      ("batch", "seq", cfg.d_model))]
    if pooled or head is not None:
        inits["cls_index"] = np.array(0, np.int64)
        nodes.append(make_node("Gather", ["last_hidden_state", "cls_index"],
                               ["cls"], axis=1))
        outputs.append(make_tensor_value_info("cls", np.float32,
                                              ("batch", cfg.d_model)))
    inputs = [make_tensor_value_info(n, np.int64, ("batch", "seq"))
              for n in ("input_ids", "attention_mask")]
    if head is not None:
        inits["head.w"] = np.asarray(head[0], np.float32)
        inits["head.b"] = np.asarray(head[1], np.float32)
        nodes += [make_node("MatMul", ["cls", "head.w"], ["head.mm"]),
                  make_node("Add", ["head.mm", "head.b"], ["logits"]),
                  make_node("SoftmaxCrossEntropyLoss", ["logits", "labels"],
                            ["loss"], reduction="mean")]
        outputs = [make_tensor_value_info("logits", np.float32,
                                          ("batch", len(head[1]))),
                   make_tensor_value_info("loss", np.float32, ())]
        inputs.append(make_tensor_value_info("labels", np.int64,
                                             ("batch",)))
    graph = make_graph(
        nodes, "bert_encoder_ort", inputs=inputs, outputs=outputs,
        initializers=inits)
    return make_model(graph, opset=17, extra_opsets={"com.microsoft": 1})


def float_activations(model_bytes, x):
    """Every tensor of the float graph ``model_bytes`` on the float32 batch
    ``x`` (a CPU tensor fed to its first input), as numpy: the port's
    converter on the CPU."""
    import torch
    from mmlspark_tpu_torch.onnx.convert import _Ctx, _eval_nodes
    from mmlspark_tpu_torch.onnx import convert_model
    cm = convert_model(model_bytes)
    env = dict(cm.const_params)
    env.update({k: torch.from_numpy(v) for k, v in cm.params.items()})
    env[cm.input_names[0]] = x
    env[""] = None
    with torch.inference_mode():
        _eval_nodes(cm.model.graph.nodes, env,
                    _Ctx(cm.model.opset, torch.device("cpu")))
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in env.items() if k}


def qoperator_resnet_onnx(model_bytes, calib):
    """``export_resnet_onnx``'s folded-conv ResNet in onnxruntime's
    QOperator layout, its activation scales calibrated per tensor by
    min/max over ``calib`` (a float32 (N, 3, H, W) CPU tensor, the graph's
    normalized input) run through the float graph:

    * ``QuantizeLinear`` on the input (uint8, asymmetric);
    * each Conv a ``QLinearConv`` with symmetric int8 weights per output
      channel and int32 biases at x_scale · w_scale; an output that feeds
      a Relu is uint8 with zero point 0, so the saturation is the Relu,
      the others (a block's last conv, its projection) symmetric int8;
    * the stem ``MaxPool`` in float between a ``DequantizeLinear`` and a
      ``QuantizeLinear`` at the stem's scale;
    * each skip join a ``QLinearAdd`` whose uint8, zero-point-0 output is
      the join's Relu;
    * ``QLinearGlobalAveragePool``, ``Flatten``, then ``QGemm`` (per-tensor
      int8 weights, int32 bias) with float logits, the one output.

    A quantizer for tests and ``chip_smoke.py``, not a package feature."""
    import numpy as np
    from mmlspark_tpu_torch.onnx.builder import (make_graph, make_model,
                                                 make_node,
                                                 make_tensor_value_info)
    from mmlspark_tpu_torch.onnx.proto import parse_model, tensor_to_numpy
    model = parse_model(model_bytes)
    g = model.graph
    weights = {t.name: tensor_to_numpy(t) for t in g.initializers}
    acts = float_activations(model_bytes, calib)
    consumers = {}
    for n in g.nodes:
        for i in n.input:
            consumers.setdefault(i, []).append(n)
    ms = {"domain": "com.microsoft"}
    inits, nodes, qname = {}, [], {}
    f32 = np.float32

    def scale(name, s, zp):
        """The (scale, zero point) initializers of quantized tensor
        ``name``; ``zp`` carries the tensor's type."""
        inits[name + "_s"] = f32(s if s > 0 else 1.0).reshape(())
        inits[name + "_zp"] = np.asarray(zp).reshape(())
        return [name + "_s", name + "_zp"]

    def unsigned(name):                   # non-negative: uint8, zp 0
        return scale(name, float(acts[name].max()) / 255.0, np.uint8(0))

    def symmetric(name):                  # signed: int8, zp 0
        return scale(name, float(np.abs(acts[name]).max()) / 127.0,
                     np.int8(0))

    def relu_after(name):
        nxt = consumers.get(name, [])
        return nxt[0] if len(nxt) == 1 and nxt[0].op_type == "Relu" else None

    inp = g.inputs[0].name
    lo = min(0.0, float(acts[inp].min()))
    hi = max(0.0, float(acts[inp].max()))
    s_in = (hi - lo) / 255.0
    q_in = scale(inp, s_in, np.uint8(np.clip(round(-lo / s_in), 0, 255)))
    nodes.append(make_node("QuantizeLinear", [inp] + q_in, [inp + "_q"]))
    qname[inp] = (inp + "_q", q_in)
    skip = set()
    for n in g.nodes:
        if id(n) in skip:
            continue
        if n.op_type == "Conv":
            relu = relu_after(n.output[0])
            out = relu.output[0] if relu is not None else n.output[0]
            q_out = unsigned(out) if relu is not None else symmetric(out)
            if relu is not None:
                skip.add(id(relu))
            w = weights[n.input[1]]
            ws = (np.abs(w).reshape(w.shape[0], -1).max(1) / 127.0) \
                .astype(f32)
            ws = np.where(ws > 0, ws, f32(1.0)).astype(f32)
            x_q, q_x = qname[n.input[0]]
            wq = np.clip(np.round(w / ws[:, None, None, None]), -127, 127)
            x_s = inits[q_x[0]]
            bq = np.round(weights[n.input[2]] / (x_s * ws)).astype(np.int32)
            inits.update({n.input[1] + "_q": wq.astype(np.int8),
                          n.input[1] + "_s": ws,
                          n.input[1] + "_zp": np.int8(0).reshape(()),
                          n.input[2] + "_q": bq})
            attrs = {k: n.attr(k) for k in n.attributes}
            nodes.append(make_node(
                "QLinearConv",
                [x_q] + q_x + [n.input[1] + "_q", n.input[1] + "_s",
                               n.input[1] + "_zp"] + q_out
                + [n.input[2] + "_q"], [out + "_q"], **attrs))
            qname[out] = (out + "_q", q_out)
        elif n.op_type == "MaxPool":
            x_q, q_x = qname[n.input[0]]
            out = n.output[0]
            attrs = {k: n.attr(k) for k in n.attributes}
            nodes += [make_node("DequantizeLinear", [x_q] + q_x,
                                [out + "_in"]),
                      make_node("MaxPool", [out + "_in"], [out + "_f"],
                                **attrs),
                      make_node("QuantizeLinear", [out + "_f"] + q_x,
                                [out + "_q"])]
            qname[out] = (out + "_q", q_x)
        elif n.op_type == "Add":
            relu = relu_after(n.output[0])
            if relu is None:
                raise ValueError(f"Add {n.output[0]} without its Relu")
            skip.add(id(relu))
            out = relu.output[0]
            q_out = unsigned(out)
            (a_q, q_a), (b_q, q_b) = qname[n.input[0]], qname[n.input[1]]
            nodes.append(make_node("QLinearAdd", [a_q] + q_a + [b_q] + q_b
                                   + q_out, [out + "_q"], **ms))
            qname[out] = (out + "_q", q_out)
        elif n.op_type == "GlobalAveragePool":
            x_q, q_x = qname[n.input[0]]
            out = n.output[0]
            q_out = unsigned(out)
            nodes.append(make_node("QLinearGlobalAveragePool",
                                   [x_q] + q_x + q_out, [out + "_q"], **ms))
            qname[out] = (out + "_q", q_out)
        elif n.op_type == "Flatten":
            x_q, q_x = qname[n.input[0]]
            out = n.output[0]
            nodes.append(make_node("Flatten", [x_q], [out + "_q"],
                                   axis=n.attr("axis", 1)))
            qname[out] = (out + "_q", q_x)
        elif n.op_type == "Gemm":
            x_q, q_x = qname[n.input[0]]
            w, b = weights[n.input[1]], weights[n.input[2]]
            ws = f32(max(float(np.abs(w).max()), 1e-12) / 127.0)
            x_s = inits[q_x[0]]
            inits.update({
                n.input[1] + "_q": np.clip(np.round(w / ws), -127, 127)
                .astype(np.int8),
                n.input[1] + "_s": ws.reshape(()),
                n.input[1] + "_zp": np.int8(0).reshape(()),
                n.input[2] + "_q": np.round(b / (x_s * ws)).astype(np.int32)})
            nodes.append(make_node(
                "QGemm", [x_q] + q_x + [n.input[1] + "_q", n.input[1] + "_s",
                                        n.input[1] + "_zp",
                                        n.input[2] + "_q"],
                [n.output[0]], **ms))
        else:
            raise ValueError(f"no QOperator form for {n.op_type}")
    logits = g.outputs[0]
    graph = make_graph(
        nodes, "resnet_qoperator",
        [make_tensor_value_info(inp, np.float32, list(g.inputs[0].shape))],
        [make_tensor_value_info(logits.name, np.float32,
                                list(logits.shape))],
        initializers=inits)
    return make_model(graph, opset=model.opset,
                      extra_opsets={"com.microsoft": 1})


def qlinear_conv_outputs(model_bytes):
    """The output names of a graph's ``QLinearConv`` nodes, in order."""
    from mmlspark_tpu_torch.onnx.proto import parse_model
    return [n.output[0] for n in parse_model(model_bytes).graph.nodes
            if n.op_type == "QLinearConv"]


def bert_rows(rows, seq, vocab, seed):
    """(ids, mask) int64 (rows, seq): right-padded rows whose lengths a
    seeded generator draws from seq / 16 ... seq (32 ... 512 at 512),
    padding ids 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(seq // 16, seq + 1, rows)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int64)
    ids = rng.integers(1, vocab, (rows, seq)) * mask
    return ids.astype(np.int64), mask


def _bert_model(model_bytes, dtype, batch, device=None, **kw):
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    return ONNXModel(model_bytes, device=device,
                     feed_dict={"input_ids": "input_ids",
                                "attention_mask": "attention_mask"},
                     fetch_dict={"hidden": "last_hidden_state"},
                     mini_batch_size=batch, compute_dtype=dtype, **kw)


def _zero_k7_counts():
    from mmlspark_tpu_torch.onnx import convert
    from mmlspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                        flash_attention_plain)
    flash_attention.launches = 0
    flash_attention_plain.calls = 0
    convert.dense_on_cuda.clear()


def _k7_counts(what, want):
    """K7 launches since ``_zero_k7_counts``; raises unless they are
    ``want`` and no plain call or dense ``_attention_core`` call ran on the
    card."""
    from mmlspark_tpu_torch.onnx import convert
    from mmlspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                        flash_attention_plain)
    got = flash_attention.launches
    dense = dict(convert.dense_on_cuda)
    if got != want or flash_attention_plain.calls or dense:
        raise AssertionError(f"{what}: {got} K7 launches (want {want}), "
                             f"{flash_attention_plain.calls} plain calls, "
                             f"dense attention on the card {dense}")
    return got


def _k7_onnx_timing(dev_info, mask, heads, head_dim):
    """K7 alone at 14b's call shape (bf16, B = 32, H = 12, S = 512, D = 64,
    the first batch's key mask): its time beside the plain version, SDPA
    with the same mask and the bound, its error against the plain version
    in f32, and the three contiguous copies ``_attention_core`` makes of
    the q/k/v heads an Attention node splits off."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.onnx import convert
    from mmlspark_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
    kmask = torch.from_numpy(mask != 0).to(dev)
    B, S = kmask.shape
    H, D = heads, head_dim
    gen = torch.Generator(device=dev).manual_seed(141)
    slab = B * H * S * D * 2
    copies = [[torch.randn(B, H, S, D, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3)]
              for _ in range(_copies(3 * slab))]
    q, k, v = copies[0]
    o = fa._fwd_kernel(q, k, v, kmask, False, D ** -0.5, False)[0]
    f32 = [t.float() for t in (q, k, v)]
    want = fa.flash_attention_plain(*f32, kmask)[0]
    r_o = fa.flash_attention_plain(f32[0], f32[1], f32[2].abs(), kmask)[0]
    err = _ulp_check("14b K7", o, want, r_o)
    lib = fa._library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = []

    def fwd(c):
        return lambda: rc.append(lib.mmlspark_fa_fwd(
            fa._DTYPES[torch.bfloat16], D, c[0].data_ptr(), c[1].data_ptr(),
            c[2].data_ptr(), kmask.data_ptr(), o.data_ptr(), None, None,
            B * H, H, S, D ** -0.5, 0, stream))

    ms = _cuda_ms([fwd(c) for c in copies], 50)
    if any(rc):
        raise AssertionError(f"14b K7: launch returned {set(rc)}")
    plain_ms = _cuda_ms([lambda c=c: fa.flash_attention_plain(
        c[0], c[1], c[2], kmask) for c in copies], 5)
    sdpa_mask = kmask[:, None, None, :]
    lib_ms = _cuda_ms([lambda c=c: F.scaled_dot_product_attention(
        c[0], c[1], c[2], attn_mask=sdpa_mask) for c in copies], 50)
    del copies
    # the copies: q/k/v as the transposed views an Attention node's packed
    # (B, S, 3 H D) projection gives, made contiguous for K7
    qkvs = [torch.randn(B, S, 3 * H * D, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(_copies(3 * slab))]
    views = [[convert._split_heads(t, B, S, H)
              for t in qkv.split(H * D, dim=-1)] for qkv in qkvs]
    copy_ms = _cuda_ms([lambda vs=vs: [convert._k7_operand(t) for t in vs]
                        for vs in views], 20)
    del qkvs, views
    torch.cuda.empty_cache()
    pairs = H * fa.attention_pairs(kmask, B, S, False)
    kv_frac = kmask.float().mean().item()
    bound = _bound(dev_info, slab + 2 * slab * kv_frac + slab + B * S,
                   4 * D * pairs, "flops")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": lib_ms, "contiguous_copies_ms": copy_ms,
            "copies_bound_ms": _bound(dev_info, 6 * slab, 0)["bound_ms"],
            "shape": {"B": B, "H": H, "S": S, "D": D, "causal": False,
                      "mask": "14b's first batch", "dtype": "bfloat16",
                      "pairs": pairs, "valid_key_share": kv_frac}}


def _bert_batch_fn_ms(m, ids, mask):
    """The model's batch function (input prep, the graph, the fetch) on
    one resident batch, outputs left on the card: device ms by CUDA events
    and host issue ms."""
    import torch
    dev = torch.device("cuda")
    fn, params = m._ensure_fn(), m._params_for_device(dev)
    feeds = {"input_ids": torch.from_numpy(ids).to(dev),
             "attention_mask": torch.from_numpy(mask).to(dev)}
    with torch.inference_mode():
        fn(params, feeds)
        torch.cuda.synchronize()
        return {"batch_fn_device_ms": _cuda_ms([lambda: fn(params, feeds)],
                                               3),
                "batch_fn_host_ms": _host_ms([lambda: fn(params, feeds)], 3)}


def _bert_passes(m, df, passes):
    """Median sequences/s over ``passes`` timed transforms of ``df``
    (outputs drained to the host), and the last output."""
    import torch
    times, out = [], None
    for _ in range(passes):
        t0 = time.perf_counter()
        out = m.transform(df)["hidden"]
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return len(df) / statistics.median(times), times, out


def phase_onnx_bert_encoder(dev_info):
    """14a-14b: the ORT-optimized BERT-base through ``DataFrame`` →
    ``ONNXModel.transform``, each Attention node one K7 launch."""
    import numpy as np
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.zoo.bert_onnx import (BertOnnxConfig,
                                                         export_bert_onnx,
                                                         init_bert_params)
    cfg = BertOnnxConfig(**BERT_ONNX)
    c = ONNX_BERT
    t0 = time.perf_counter()
    params = init_bert_params(cfg, seed=0)
    graphs = {"fused": fused_bert_onnx(cfg, params),
              "decomposed": export_bert_onnx(cfg, params=params, opset=17)}
    export_s = time.perf_counter() - t0
    del params
    ids, mask = bert_rows(c["rows"], c["seq"], cfg.vocab, c["seed"])
    df = DataFrame({"input_ids": ids, "attention_mask": mask})
    batches = -(-c["rows"] // c["batch"])
    per_batch = cfg.layers

    # 14a: f32 at full width. Tolerance 1e-3 of the largest |hidden| (f32
    # sums in other orders through 12 layers; every query row has a valid
    # key, so flash and dense define the same function; a wrong head
    # split, mask or gelu moves the states by O(max|h|))
    f32 = {}
    launches = {}
    for name in ("fused", "decomposed"):
        _zero_k7_counts()
        f32[name] = _bert_model(graphs[name], "float32",
                                c["batch"]).transform(df)["hidden"]
        launches[f"14a {name}"] = _k7_counts(
            f"14a {name}", per_batch * batches if name == "fused" else 0)
    ncpu = c["cpu_rows"]
    cpu = _bert_model(graphs["fused"], "float32", ncpu,
                      device="cpu").transform(df.head(ncpu))["hidden"]
    ref = float(np.abs(f32["decomposed"]).max())
    tol = 1e-3 * ref
    errs = {"fused_vs_decomposed": float(np.abs(
                f32["fused"] - f32["decomposed"]).max()),
            "fused_vs_cpu": float(np.abs(f32["fused"][:ncpu] - cpu).max()),
            "decomposed_vs_cpu": float(np.abs(
                f32["decomposed"][:ncpu] - cpu).max())}
    shape = (c["rows"], c["seq"], cfg.d_model)
    if any(h.shape != shape or not np.isfinite(h).all()
           for h in f32.values()):
        raise AssertionError(f"14a: hidden shapes "
                             f"{[h.shape for h in f32.values()]} (want "
                             f"{shape}) or not finite")
    if not all(e <= tol for e in errs.values()):
        raise AssertionError(f"14a: f32 hidden states off: {errs}, bound "
                             f"{tol}")
    a = {"rows": c["rows"], "batch": c["batch"], "cpu_rows": ncpu,
         "export_s": export_s, "valid_token_share": float(mask.mean()),
         "bound": tol, "max_abs_hidden": ref, **errs,
         "k7_launches": launches["14a fused"],
         "k7_launches_decomposed": launches["14a decomposed"]}
    log(f"[onnx bert 14a] {json.dumps(a)}")

    # 14b: bf16 at the "infer" shape, each graph warmed (warm_up over the
    # dynamic sequence axis, one untimed pass), then timed passes
    specs = {n: (np.int64, (c["seq"],))
             for n in ("input_ids", "attention_mask")}
    b = {"rows": c["rows"], "batch": c["batch"], "dtype": "bfloat16"}
    bf16 = {}
    for name in ("fused", "decomposed"):
        m = _bert_model(graphs[name], "bfloat16", c["batch"])
        warm = m.warm_up(batch_sizes=[c["batch"]], input_specs=specs)
        m.transform(df)
        _zero_k7_counts()
        sps, times, bf16[name] = _bert_passes(m, df, c["passes"])
        launches[f"14b {name}"] = _k7_counts(
            f"14b {name}", per_batch * batches * c["passes"]
            if name == "fused" else 0)
        b[name] = {"seq_per_s": sps, "pass_s": times,
                   "ms_per_batch": statistics.median(times) / batches * 1e3,
                   "warm_up": warm, "k7_launches": launches[f"14b {name}"],
                   "max_abs_vs_f32_fused": float(np.abs(
                       bf16[name] - f32["fused"]).max()),
                   **_bert_batch_fn_ms(m, ids[:c["batch"]],
                                       mask[:c["batch"]])}
        del m
    # bf16 against 14a's fused f32: activations round to bf16 at every
    # node and K7 rounds P once, through 12 layers; 2^-4 of the largest
    # f32 |hidden| (the bound 11b holds ResNet-50's logits to)
    bf_bound = 2.0 ** -4 * float(np.abs(f32["fused"]).max())
    b["bf16_bound"] = bf_bound
    if not (np.isfinite(bf16["fused"]).all()
            and b["fused"]["max_abs_vs_f32_fused"] <= bf_bound):
        raise AssertionError(f"14b: bf16 fused hidden off f32 by "
                             f"{b['fused']['max_abs_vs_f32_fused']} "
                             f"(bound {bf_bound}) or not finite")
    k7 = _k7_onnx_timing(dev_info, mask[:c["batch"]], cfg.heads,
                         cfg.d_model // cfg.heads)
    b["k7"] = k7
    b["k7_and_copies_share_of_batch"] = (
        per_batch * (k7["ms"] + k7["contiguous_copies_ms"])
        / b["fused"]["ms_per_batch"])
    log(f"[onnx bert 14b] {json.dumps(b)} | {dev_info['smi']}")
    return a, b, launches


def _one_node_graph(op, ins, feeds, inits, outs, opset=17, **attrs):
    """A one-node graph (the port's builder), converted, and its feeds:
    (converted model, ``feeds``)."""
    import numpy as np
    from mmlspark_tpu_torch.onnx import (convert_model, make_graph,
                                         make_model, make_node,
                                         make_tensor_value_info)
    g = make_graph([make_node(op, ins, outs, **attrs)], op,
                   [make_tensor_value_info(k, v.dtype, list(v.shape))
                    for k, v in feeds.items()],
                   [make_tensor_value_info(o, np.float32, []) for o in outs],
                   initializers=inits)
    data = make_model(g, opset=opset, extra_opsets={"com.microsoft": 1})
    return convert_model(data), feeds


def _run_card_and_cpu(what, cm, feeds, k7_want):
    """``cm`` on the card (params and feeds as CUDA tensors) and on the
    CPU; K7 launches counted on the card run. Returns (card, cpu) outputs
    as CPU tensors."""
    import torch
    dev = torch.device("cuda")
    params = {k: torch.from_numpy(v).to(dev) for k, v in cm.params.items()}
    _zero_k7_counts()
    card = cm(params, {k: torch.from_numpy(v.copy()).to(dev)
                       for k, v in feeds.items()})
    torch.cuda.synchronize()
    _k7_counts(what, k7_want)
    cpu = cm({k: torch.from_numpy(v) for k, v in cm.params.items()},
             {k: torch.from_numpy(v.copy()) for k, v in feeds.items()})
    return {k: t.cpu() for k, t in card.items()}, cpu


def _rope_cache(max_pos, rot_dim, theta=10000.0):
    import numpy as np
    half = rot_dim // 2
    inv = 1.0 / theta ** (np.arange(half) / half)
    ang = np.arange(max_pos)[:, None] * inv[None, :]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def phase_onnx_attention_nodes(dev_info):
    """14c: one-node attention graphs on the card, each one K7 launch,
    against the same graph on the port's CPU path (1e-3 of the largest
    |output|, f32); a GroupQueryAttention decode step on the dense path,
    its cache bitwise the CPU's."""
    import numpy as np
    import torch
    rng = np.random.default_rng(143)

    def normal(*shape, s=1.0):
        return rng.normal(0, s, shape).astype(np.float32)

    B, S, Hd, H = 2, 256, 768, 12
    lens = np.array([S, 131], np.int32)
    pad = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    cases = {
        "Attention unidirectional": _one_node_graph(
            "Attention", ["x", "w", "b", "lens"],
            {"x": normal(B, S, Hd), "lens": lens},
            {"w": normal(Hd, 3 * Hd, s=0.03), "b": normal(3 * Hd, s=0.1)},
            ["y"], domain="com.microsoft", num_heads=H, unidirectional=1),
        "MultiHeadAttention": _one_node_graph(
            "MultiHeadAttention", ["q", "k", "v", "", "m"],
            {"q": normal(B, S, Hd), "k": normal(B, S, Hd),
             "v": normal(B, S, Hd), "m": pad}, {}, ["y"],
            domain="com.microsoft", num_heads=H),
        "ai.onnx Attention causal": _one_node_graph(
            "Attention", ["q", "k", "v"],
            {n: normal(B, H, S, Hd // H) for n in "qkv"}, {}, ["y"],
            opset=23, is_causal=1),
    }
    Bg, Sg, Hq, Hkv, Dg = 4, 512, 32, 8, 128
    glen = rng.integers(64, Sg + 1, Bg).astype(np.int32)
    cos_c, sin_c = _rope_cache(Sg + 64, Dg)
    gqa = dict(domain="com.microsoft", num_heads=Hq, kv_num_heads=Hkv,
               do_rotary=1)
    cases["GroupQueryAttention prefill"] = _one_node_graph(
        "GroupQueryAttention", ["q", "k", "v", "", "", "sl", "tl", "cc",
                                "sc"],
        {"q": normal(Bg, Sg, Hq * Dg), "k": normal(Bg, Sg, Hkv * Dg),
         "v": normal(Bg, Sg, Hkv * Dg), "sl": glen - 1,
         "tl": np.array(Sg, np.int32)},
        {"cc": cos_c, "sc": sin_c}, ["y"], **gqa)
    rec = {}
    for what, (cm, feeds) in cases.items():
        card, cpu = _run_card_and_cpu(f"14c {what}", cm, feeds, 1)
        ref = cpu["y"].abs().max().item()
        err = (card["y"] - cpu["y"]).abs().max().item()
        if not (torch.isfinite(card["y"]).all() and err <= 1e-3 * ref):
            raise AssertionError(f"14c {what}: card vs CPU {err}, bound "
                                 f"{1e-3 * ref}")
        rec[what] = {"max_abs_vs_cpu": err, "bound": 1e-3 * ref,
                     "k7_launches": 1}
    # one decode step over a static cache: dense, the cache written in
    # place at each row's own position
    S_max = Sg + 64
    past = rng.integers(Sg // 2, S_max - 1, Bg).astype(np.int32)
    cm, feeds = _one_node_graph(
        "GroupQueryAttention", ["q", "k", "v", "pk", "pv", "sl", "tl", "cc",
                                "sc"],
        {"q": normal(Bg, 1, Hq * Dg), "k": normal(Bg, 1, Hkv * Dg),
         "v": normal(Bg, 1, Hkv * Dg), "pk": normal(Bg, Hkv, S_max, Dg),
         "pv": normal(Bg, Hkv, S_max, Dg), "sl": past,
         "tl": np.array(int(past.max()) + 1, np.int32)},
        {"cc": cos_c, "sc": sin_c}, ["y", "ok", "ov"], **gqa)
    card, cpu = _run_card_and_cpu("14c GQA decode", cm, feeds, 0)
    ref = cpu["y"].abs().max().item()
    err = (card["y"] - cpu["y"]).abs().max().item()
    same = all(torch.equal(card[n], cpu[n]) for n in ("ok", "ov"))
    if not (err <= 1e-3 * ref and same):
        raise AssertionError(f"14c GQA decode: card vs CPU {err} (bound "
                             f"{1e-3 * ref}), caches bitwise {same}")
    rec["GroupQueryAttention decode"] = {
        "max_abs_vs_cpu": err, "bound": 1e-3 * ref, "k7_launches": 0,
        "caches_bitwise_cpu": same}
    log(f"[onnx bert 14c] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_onnx_vit_decoder(dev_info, params_np):
    """14d: ViT-B/16's logits from ``export_vit_onnx`` through ``ONNXModel``
    on the card against the CPU; FULL's decoder from
    ``export_decoder_onnx``, 8 decode steps on the card against the CPU."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    from mmlspark_tpu_torch.models.zoo.decoder_onnx import export_decoder_onnx
    from mmlspark_tpu_torch.models.zoo.vit import (ViTConfig,
                                                   export_vit_onnx,
                                                   init_vit_params)
    from mmlspark_tpu_torch.onnx import convert_model
    vcfg = ViTConfig(**VIT_B16)
    mb = export_vit_onnx(vcfg, params=init_vit_params(vcfg, seed=0))
    px = np.random.default_rng(144).normal(
        0, 1, (8, 3, vcfg.image_size, vcfg.image_size)).astype(np.float32)
    logits = {}
    for dev in (None, "cpu"):
        m = ONNXModel(mb, device=dev, feed_dict={"pixel_values": "pixels"},
                      fetch_dict={"logits": "logits"}, mini_batch_size=8)
        logits[dev] = m.transform(DataFrame({"pixels": px}))["logits"]
    ref = float(np.abs(logits["cpu"]).max())
    vit_err = float(np.abs(logits[None] - logits["cpu"]).max())
    if logits[None].shape != (8, vcfg.num_classes) or \
            not vit_err <= 1e-3 * ref:
        raise AssertionError(f"14d ViT-B/16: logits {logits[None].shape}, "
                             f"card vs CPU {vit_err} (bound {1e-3 * ref})")
    # the decoder: one token a step, static caches advancing in place
    cfg = _full_cfg(torch.float32)
    steps, B = 8, 2
    cm = convert_model(export_decoder_onnx(cfg, params_np, max_len=steps))
    hd = cfg.d_model // cfg.heads
    tokens = np.random.default_rng(145).integers(0, cfg.vocab, (B, steps))
    runs = {}
    _zero_k7_counts()
    for run, dev in (("card", torch.device("cuda")),
                     ("cpu", torch.device("cpu"))):
        params = {k: torch.from_numpy(v).to(dev)
                  for k, v in cm.params.items()}
        cache = {f"past_{kv}_{i}": torch.zeros(B, cfg.heads, steps, hd,
                                               device=dev)
                 for i in range(cfg.layers) for kv in "kv"}
        out = []
        for t in range(steps):
            feeds = {"token": torch.from_numpy(tokens[:, t:t + 1]).to(dev),
                     "seqlens": torch.full((B,), t, dtype=torch.int32,
                                           device=dev),
                     "total": torch.tensor(t + 1, dtype=torch.int32,
                                           device=dev), **cache}
            res = cm(params, feeds)
            out.append(res["logits"].cpu())
            cache = {k.replace("present", "past"): v for k, v in res.items()
                     if k.startswith("present")}
        runs[run] = out
    _k7_counts("14d decoder", 0)
    dec_err = []
    for t in range(steps):
        ref_t = runs["cpu"][t].abs().max().item()
        e = (runs["card"][t] - runs["cpu"][t]).abs().max().item()
        if not e <= 1e-3 * ref_t:
            raise AssertionError(f"14d decoder step {t}: card vs CPU {e} "
                                 f"(bound {1e-3 * ref_t})")
        dec_err.append(e)
    rec = {"vit_b16": {"rows": 8, "max_abs_vs_cpu": vit_err,
                       "bound": 1e-3 * ref},
           "decoder": {"steps": steps, "rows": B,
                       "max_abs_vs_cpu_by_step": dec_err}}
    log(f"[onnx bert 14d] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


#: 15a: scripts/bench_decode.py's continuous-batching row (bench_decode.py:
#: 136-182) at its full width: 32 slots, 128-token prompts, 128 new
#: tokens, 64 requests after a 32-request warm-up of 2 new tokens
DECODE_CB = dict(slots=32, prompt=128, new=128, requests=64,
                 steps_per_dispatch=16, pipeline_depth=2, prefill_ahead=32)
#: 15b: bench.py's failover engine (bench.py:706-758) at FULL's widths
FAILOVER = dict(max_slots=2, max_len=64, page_size=8)
FAILOVER_PROMPT = (5, 13)       # np.arange(5, 13)
FAILOVER_NEW = 16
FAILOVER_STEPS = 6


def _launch_split(what, calls, chunks, hits, layers, f32):
    """K1/K2 launches since the last zeroing, split by the body the
    library reported, against the engine's own count: its ``calls``
    attention calls are its prefill chunks and prefix suffixes (one
    extend a layer each: the FMA body in f32, the tensor-core body in
    bf16) and its decode steps (the rest, one split launch a layer each).
    No mesh launch."""
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    p = paged_attention_window
    b = _bodies()
    total = p.launches + p.launches_q
    split, mma = b["split"] + b["q_split"], b["mma"] + b["q_mma"]
    extends, steps = chunks + hits, calls - chunks - hits
    got = {"split": split, "mma": mma, "fma": total - split - mma}
    want = {"split": steps * layers,
            "mma": 0 if f32 else extends * layers,
            "fma": extends * layers if f32 else 0}
    if got != want or total <= 0 or p.launches_window or \
            p.launches_window_q:
        raise AssertionError(
            f"{what}: K1 {p.launches}, K2 {p.launches_q} launches by body "
            f"{got}; want {want} from {steps} decode steps, {chunks} "
            f"chunks and {hits} prefix suffixes x {layers} layers")
    return {"k1": p.launches, "k2": p.launches_q, **got,
            "decode_steps": steps, "extends": extends}


def _drive(eng, reqs):
    while not all(r.done for r in reqs):
        eng.step()


def _cb_run(params_np, cfg, ahead):
    """One pass of bench_decode.py's continuous-batching row through a
    ``ContinuousDecoder`` (its settings, ``prefill_ahead=ahead``): the
    warm-up, then the timed 64 requests. Returns (record, tokens)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    c = DECODE_CB
    B, P, T = c["slots"], c["prompt"], c["new"]
    eng = ContinuousDecoder(params_np, cfg, max_slots=B, max_len=P + T + 1,
                            steps_per_dispatch=c["steps_per_dispatch"],
                            pipeline_depth=c["pipeline_depth"],
                            prefill_ahead=ahead)
    rng2 = np.random.default_rng(1)
    _drive(eng, [eng.submit(rng2.integers(0, cfg.vocab, P), 2)
                 for _ in range(B)])
    torch.cuda.synchronize()
    stats0 = dict(eng._kv.stats)
    chunks0, hits0 = len(eng._chunk_trace), eng.stats["prefix_hits"]
    staged0 = eng.stats.get("staged_prefills", 0)
    _zero_pa_counts()
    reqs = [eng.submit(rng2.integers(0, cfg.vocab, P), T)
            for _ in range(c["requests"])]
    t0 = time.perf_counter()
    _drive(eng, reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    calls = eng._kv.stats["attn_ticks_kernel"] - stats0["attn_ticks_kernel"]
    counts = _launch_split(f"15a prefill_ahead={ahead}", calls,
                           len(eng._chunk_trace) - chunks0,
                           eng.stats["prefix_hits"] - hits0, cfg.layers,
                           cfg.dtype == torch.float32)
    toks = [eng.result(r, timeout=1) for r in reqs]
    if any(len(t) != T or not all(0 <= x < cfg.vocab for x in t)
           for t in toks):
        raise AssertionError("15a: a request came back short or out of "
                             "the vocabulary")
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    n_tok = sum(len(t) for t in toks)
    rec = {"tok_per_s": n_tok / dt, "tokens": n_tok, "wall_s": dt,
           "slots": B, "requests": len(reqs), "prompt_len": P,
           "new_tokens": T, "steps_per_dispatch": c["steps_per_dispatch"],
           "pipeline_depth": c["pipeline_depth"], "prefill_ahead": ahead,
           "staged_prefills": eng.stats.get("staged_prefills", 0) - staged0,
           "prefills": eng.stats["prefills"],
           "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
           "ttft_max_ms": 1e3 * ttft[-1],
           "dispatches": len(eng.tick_seconds), "launches": counts}
    del eng
    torch.cuda.empty_cache()
    return rec, toks


def phase_decode_cb(params_np, single, dev_info):
    """15a: f32 parity first (phase 4's engine with ``prefill_ahead=4`` and
    nine of phase 4's prompts for its four slots: each request's tokens
    are phase 4's for its prompt, and the stage was used), then
    bench_decode.py's row in bf16 with ``prefill_ahead=32`` and, in the
    same process, with 0."""
    import torch
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    cfg32 = _full_cfg(torch.float32)
    prompts = _parity_prompts(cfg32.vocab)
    order = [0, 1, 2, 0, 1, 1, 0, 0, 2]
    eng = ContinuousDecoder(params_np, cfg32, prefill_ahead=4, **PARITY)
    _zero_pa_counts()
    reqs = [eng.submit(prompts[i], PARITY_NEW) for i in order]
    _drive(eng, reqs)
    eng.flush()
    for i, r in zip(order, reqs):
        if eng.result(r, timeout=1) != single[None][i]:
            raise AssertionError(f"15a f32: prompt {i} gave {r.tokens}, "
                                 f"phase 4 {single[None][i]}")
    staged = eng.stats.get("staged_prefills", 0)
    if staged < 1:
        raise AssertionError("15a f32: nothing was staged")
    parity = {"requests": len(reqs), "staged_prefills": staged,
              "launches": _launch_split(
                  "15a f32", eng._kv.stats["attn_ticks_kernel"],
                  len(eng._chunk_trace), eng.stats["prefix_hits"],
                  cfg32.layers, True)}
    del eng
    torch.cuda.empty_cache()
    log(f"[decode cb] f32 parity: {len(reqs)} requests == phase 4's tokens; "
        f"{json.dumps(parity)}")
    cfg = _full_cfg(torch.bfloat16)
    staged_rec, staged_toks = _cb_run(params_np, cfg,
                                      DECODE_CB["prefill_ahead"])
    if staged_rec["staged_prefills"] < 1:
        raise AssertionError("15a: prefill_ahead=32 staged nothing")
    plain_rec, plain_toks = _cb_run(params_np, cfg, 0)
    same = sum(a == b for a, b in zip(staged_toks, plain_toks))
    rec = {"f32_parity": parity, "prefill_ahead": staged_rec,
           "no_prefill_ahead": plain_rec,
           "identical_requests": same, "identical_share":
           same / len(staged_toks)}
    log(f"[decode cb] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _blob_bytes_equal(what, blob, pool, pages):
    """Every buffer's blob bytes are the pool's pages, in page order."""
    import base64
    import torch
    idx = torch.as_tensor(pages, device=pool.device)
    for layer, (c, entry) in enumerate(zip(pool.buffers, blob["data"])):
        for key, buf in c.items():
            want = buf.view(torch.uint8)[idx].cpu().numpy().tobytes()
            if base64.b64decode(entry[key]) != want:
                raise AssertionError(f"{what}: layer {layer} {key} bytes "
                                     f"differ from the pool's pages")


def _failover_case(params_np, cfg, kv_dtype, name, jdir):
    """15b for one page dtype: bench.py's ``_failover_phase`` at FULL's
    widths. Returns its record; raises where the checks fail."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    from mmlspark_tpu_torch.serving.journal import ServingJournal
    f32 = cfg.dtype == torch.float32 and kv_dtype is None

    def engine(**kw):
        return ContinuousDecoder(params_np, cfg, kv_dtype=kv_dtype,
                                 **FAILOVER, **kw)

    def finish(eng, req):
        _drive(eng, [req])
        return eng.session_result(req)

    prompt = np.arange(*FAILOVER_PROMPT, dtype=np.int32)
    base = engine()
    want = finish(base, base.submit(prompt, FAILOVER_NEW))
    del base
    src = engine()
    live = src.submit(prompt, FAILOVER_NEW)
    for _ in range(FAILOVER_STEPS):
        src.step()
    ckpt = src.checkpoint_session(live)
    blob = ckpt["kv"]
    if blob is None or live.done:
        raise AssertionError(f"15b {name}: no blob mid-decode")
    slot = src._slot_of(live)
    _blob_bytes_equal(f"15b {name} export", blob, src._kv,
                      src._slot_pages[slot][:blob["n_pages"]])
    blob_bytes = sum(len(e[k]) for e in blob["data"] for k in e)
    del src
    out = {}
    for mode in ("cold", "warm"):
        eng = engine()
        finish(eng, eng.submit(prompt, 2))        # priming request
        torch.cuda.synchronize()
        stats0, prefills0 = dict(eng._kv.stats), eng.stats["prefills"]
        chunks0 = len(eng._chunk_trace)
        _zero_pa_counts()
        t0 = time.perf_counter()
        req = eng.restore_session(ckpt["session"],
                                  kv_blob=blob if mode == "warm" else None)
        pause = 0.0
        if mode == "warm":
            # the adopted pages, before any step writes the next position
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _blob_bytes_equal(f"15b {name} adopt", blob, eng._kv,
                              eng._slot_pages[eng._slot_of(req)]
                              [:blob["n_pages"]])
            pause = time.perf_counter() - t1
        while not req.tokens and not req.done:
            eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0 - pause) * 1e3
        toks = finish(eng, req)
        eng.flush()
        out[mode] = {
            "ms": ms, "tokens": toks, "identical": toks == want,
            "prefills": eng.stats["prefills"] - prefills0,
            "launches": _launch_split(
                f"15b {name} {mode}",
                eng._kv.stats["attn_ticks_kernel"]
                - stats0["attn_ticks_kernel"],
                len(eng._chunk_trace) - chunks0, 0, cfg.layers, f32)}
        del eng
    if not out["warm"]["identical"]:
        raise AssertionError(f"15b {name}: warm {out['warm']['tokens']} vs "
                             f"uninterrupted {want}")
    if out["warm"]["prefills"] != 0:
        raise AssertionError(f"15b {name}: the warm restore prefilled")
    if f32 and not out["cold"]["identical"]:
        raise AssertionError(f"15b f32: cold {out['cold']['tokens']} vs "
                             f"uninterrupted {want}")
    rec = {"pages": name, "emitted_at_checkpoint":
           len(ckpt["session"]["emitted"]), "blob_bytes": blob_bytes,
           "blob_pages": blob["n_pages"], "blob_length": blob["length"],
           "cold_restore_ms": out["cold"]["ms"],
           "warm_adopt_ms": out["warm"]["ms"],
           "warm_reprefills": out["warm"]["prefills"],
           "cold_identical": out["cold"]["identical"],
           "warm_identical": True,
           "launches_cold": out["cold"]["launches"],
           "launches_warm": out["warm"]["launches"]}
    if not out["cold"]["identical"]:
        rec["cold_divergence"] = _divergence_gaps(
            params_np, cfg, [prompt], [out["cold"]["tokens"]], [want])
    if f32:
        # the process dies mid-decode: the journal alone restores it
        jpath = os.path.join(jdir, "failover.journal")
        if os.path.exists(jpath):
            os.remove(jpath)
        journal = ServingJournal(jpath, fsync=False)
        src = engine(journal=journal)
        live = src.submit(prompt, FAILOVER_NEW, session_id="15b")
        for _ in range(FAILOVER_STEPS):
            src.step()
        journal.close()
        sess = dict(ServingJournal.scan_sessions(jpath)["15b"], id="15b")
        del src
        eng = engine()
        got = finish(eng, eng.restore_session(sess))
        if got != want:
            raise AssertionError(f"15b journal recovery: {got} vs {want}")
        rec["journal_recovery"] = {"emitted_in_journal":
                                   len(sess["emitted"]), "identical": True}
        del eng
    torch.cuda.empty_cache()
    return rec


def phase_failover(params_np, dev_info):
    """15b: bench.py's failover phase on FULL at f32, bf16, int8 and fp8
    pages (head dim 64: bench.py's own config has 16, which the paged
    kernel does not take)."""
    import torch
    jdir = os.path.join(HERE, "build", "phase15")
    os.makedirs(jdir, exist_ok=True)
    recs = {}
    for name, dtype, kv in (("f32", torch.float32, None),
                            ("bf16", torch.bfloat16, None),
                            ("int8", torch.bfloat16, "int8"),
                            ("fp8", torch.bfloat16, "fp8")):
        recs[name] = _failover_case(params_np, _full_cfg(dtype), kv, name,
                                    jdir)
        log(f"[failover] {name} pages: {json.dumps(recs[name])} | "
            f"{dev_info['smi']}")
    return recs


def _expect_post(port, path, payload):
    """POST with ``Expect: 100-continue`` on a raw socket: the interim 100
    first, then the body, then the reply. Returns (status, body)."""
    import socket
    body = json.dumps(payload).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=300)
    try:
        s.sendall(b"POST %s HTTP/1.1\r\nHost: h\r\nContent-Type: "
                  b"application/json\r\nContent-Length: %d\r\nExpect: "
                  b"100-continue\r\n\r\n" % (path.encode(), len(body)))
        data = b""
        while b"\r\n\r\n" not in data:
            data += s.recv(4096)
        if not data.startswith(b"HTTP/1.1 100"):
            raise AssertionError(f"15c: no interim 100: {data[:40]!r}")
        s.sendall(body)
        data = data.split(b"\r\n\r\n", 1)[1]
        while b"\r\n\r\n" not in data:
            data += s.recv(4096)
        head, rest = data.split(b"\r\n\r\n", 1)
        length = int(next(line.split(b":")[1] for line in head.split(b"\r\n")
                          if line.lower().startswith(b"content-length")))
        while len(rest) < length:
            rest += s.recv(65536)
        return int(head.split(b" ")[1]), rest
    finally:
        s.close()


def phase_async_front(params_np, single, dev_info):
    """15c: ``GenerationEngine(transport="async", prefill_ahead=...)`` at
    full width. f32: phase 4's prompts over one keep-alive connection
    give phase 4's tokens. bf16: phase 5's mix (concurrent, the prefix
    owner first, one SSE stream) and one ``Expect: 100-continue`` request,
    all 200, K1 split by body as in phase 5; then ``/metrics`` carries the
    engine's, the server's, the admission queue's and the journal's
    counters."""
    import http.client
    import torch
    from mmlspark_tpu_torch.serving.generation import GenerationEngine
    cfg32 = _full_cfg(torch.float32)
    with GenerationEngine(params_np, cfg32, transport="async",
                          prefill_ahead=4, **PARITY) as eng:
        conn = http.client.HTTPConnection("127.0.0.1", eng.server.port,
                                          timeout=300)
        got = []
        for p in _parity_prompts(cfg32.vocab):
            conn.request("POST", "/generate", json.dumps(
                {"tokens": [int(t) for t in p],
                 "max_new": PARITY_NEW}).encode(),
                {"Content-Type": "application/json"})
            r = conn.getresponse()
            body = r.read()
            if r.status != 200:
                raise AssertionError(f"15c f32: {r.status} {body!r}")
            got.append(json.loads(body)["tokens"])
        conn.close()
    if got != single[None]:
        raise AssertionError(f"15c f32: {got} vs phase 4's {single[None]}")
    torch.cuda.empty_cache()
    cfg = _full_cfg(torch.bfloat16)
    max_new = 64
    payloads = _serving_payloads(cfg.vocab, max_new)
    expect = {"tokens": [int(t) for t in range(7, 71)], "max_new": max_new}
    results = {}
    # phase 5's engine at 8 slots: the 13 requests overfill it, so the
    # stage can take part
    eng = GenerationEngine(params_np, cfg, max_slots=8, max_len=1024,
                           page_size=16, prefill_chunk=256,
                           steps_per_dispatch=4, transport="async",
                           prefill_ahead=8)
    try:
        eng.start()
        st, _ = _post(eng.address, {"tokens": [1, 2, 3], "max_new": 4})
        assert st == 200
        dec = eng.decoder
        torch.cuda.synchronize()
        stats0 = dict(dec._kv.stats)
        chunks0, hits0 = len(dec._chunk_trace), dec.stats["prefix_hits"]
        staged0 = dec.stats.get("staged_prefills", 0)
        _zero_pa_counts()

        def client(i, p):
            try:
                results[i] = (_expect_post(eng.server.port, "/generate", p)
                              if i == "expect" else _post(eng.address, p))
            except Exception as e:      # recorded, checked below
                results[i] = (None, repr(e).encode())

        t0 = time.perf_counter()
        client(9, payloads[9])          # the prefix owner first
        threads = [threading.Thread(target=client, args=(i, p))
                   for i, p in list(enumerate(payloads)) + [("expect",
                                                             expect)]
                   if i != 9]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = _launch_split(
            "15c bf16",
            dec._kv.stats["attn_ticks_kernel"] - stats0["attn_ticks_kernel"],
            len(dec._chunk_trace) - chunks0,
            dec.stats["prefix_hits"] - hits0, cfg.layers, False)
        staged = dec.stats.get("staged_prefills", 0) - staged0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{eng.server.port}/metrics",
                timeout=60) as r:
            metrics = r.read().decode()
    finally:
        eng.stop()
    n_tok = 0
    for i, p in list(enumerate(payloads)) + [("expect", expect)]:
        status, body = results.get(i, (None, b"missing"))
        if status != 200:
            raise AssertionError(f"15c request {i}: {status} {body!r}")
        if isinstance(p, dict) and p.get("stream"):
            events = [json.loads(line[6:]) for line in
                      body.decode().split("\n\n") if line.startswith("data: ")]
            toks = events[-1]["tokens"]
            if not events[-1].get("done"):
                raise AssertionError("15c: the stream ended without done")
        else:
            toks = json.loads(body)["tokens"]
        if len(toks) != max_new or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"15c request {i}: {len(toks)} tokens")
        n_tok += len(toks)
    want = ("mmlspark_continuous_prefills_total ",
            "mmlspark_continuous_live_slots ",
            "mmlspark_continuous_drain_seconds_count ",
            'mmlspark_serving_requests_total{transport="async",'
            'method="POST",code="200"} ',
            'mmlspark_wfq_enqueued_total{tenant="default"} ',
            'mmlspark_journal_records_total{type="sess"} ',
            'mmlspark_journal_records_total{type="tail"} ',
            "mmlspark_journal_bytes ")
    missing = [m for m in want if m not in metrics]
    if missing:
        raise AssertionError(f"15c /metrics lacks {missing}")
    rec = {"f32_requests": len(got), "requests": len(payloads) + 1,
           "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
           "staged_prefills": staged, "launches": counts,
           "metrics_lines": len(metrics.splitlines())}
    log(f"[async front] f32 over one keep-alive connection == phase 4's "
        f"tokens; {json.dumps(rec)} | {dev_info['smi']}")
    return rec


#: phase 16: the plane's sampler period (s), so a short burst leaves a few
#: samples of each series; the capture length of 16c (s) and the tokens of
#: each request it captures (short, so that prefills run all through it)
PLANE = dict(ts_interval=0.25, profile_s=2.0, profile_new=8,
             parity_repeats=3)
#: 16b: 14b's rows through ServingEngine, batches of 32; ``bert@2`` a 25%
#: canary and a 50% shadow
PLANE_BERT = dict(canary=25, shadow=50)
PLANE_SPAN = "00f067aa0ba902b7"


def _plane_reset():
    """Every process-global singleton of the observability plane and the
    model registry, fresh (the state earlier phases left is not 16's)."""
    from mmlspark_tpu_torch import observability as obs
    from mmlspark_tpu_torch.observability import timeseries, tracing
    from mmlspark_tpu_torch.serving.registry import reset_registry
    from mmlspark_tpu_torch.tuning.observations import reset_store
    obs.reset_tracker()
    obs.reset_ledger()
    timeseries.reset_alert_engine()
    timeseries.reset_store()
    obs.reset_watchdog()
    reset_registry()
    tracing.get_flight_recorder().clear()
    reset_store()


def _plane_headers(i, k=0):
    """Request i's trace context, tenant and model: its own trace id (its
    k-th resend another), two tenants alternating, ``X-Mmlspark-Model:
    gen``."""
    return {"traceparent": f"00-{k << 16 | i + 1:032x}-{PLANE_SPAN}-01",
            "X-Mmlspark-Tenant": f"t{i % 2}", "X-Mmlspark-Model": "gen"}


def _post_h(url, payload, headers, timeout=300):
    """POST JSON with extra headers: (status, headers, body)."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **headers})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get_json(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _echo_ok(what, i, headers, k=0):
    """The reply's ``traceparent`` continues the trace of request i (its
    k-th resend) under a span of the server's own."""
    echo = headers.get("traceparent", "").split("-")
    if len(echo) != 4 or echo[1] != f"{k << 16 | i + 1:032x}" or \
            echo[2] == PLANE_SPAN:
        raise AssertionError(f"{what} request {i}: traceparent echo "
                             f"{headers.get('traceparent')!r}")


def _plane_burst(eng, payloads, results):
    """Phase 5's mix through the front with request headers: the prefix
    owner first, then the rest concurrently. Returns the wall seconds."""
    def client(i, p):
        try:
            results[i] = _post_h(eng.address, p, _plane_headers(i))
        except Exception as e:      # recorded, checked by the caller
            results[i] = (None, {}, repr(e).encode())

    t0 = time.perf_counter()
    client(9, payloads[9])
    threads = [threading.Thread(target=client, args=(i, p))
               for i, p in enumerate(payloads) if i != 9]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return time.perf_counter() - t0


def _plane_closed_loop(eng, payloads, seconds):
    """The mix kept in flight: each request sent again, under a trace of
    its own, as soon as its reply is in, until ``seconds`` have passed (a
    failed request stops its client). Returns ([(i, k, status, headers,
    body)], wall seconds)."""
    t_end = time.perf_counter() + seconds
    out = []

    def client(i, p):
        k = 0
        while time.perf_counter() < t_end:
            k += 1
            try:
                st, hdrs, body = _post_h(eng.address, p, _plane_headers(i, k))
            except Exception as e:  # recorded, checked by the caller
                st, hdrs, body = None, {}, repr(e).encode()
            out.append((i, k, st, hdrs, body))
            if st != 200:
                return

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i, p))
               for i, p in enumerate(payloads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 300)
    return out, time.perf_counter() - t0


def _stream_tokens(body):
    events = [json.loads(line[6:]) for line in body.decode().split("\n\n")
              if line.startswith("data: ")]
    if not events or not events[-1].get("done"):
        raise AssertionError(f"stream ended without done: {events[-1:]}")
    return events[-1]["tokens"]


def _metric_values(text, name):
    """{label string: value} of a metric's samples in Prometheus text."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, _, val = line.rpartition(" ")
            out[key[len(name):]] = float(val)
    return out


def _profile_trace(log_dir, timeout=120):
    """The Chrome trace a ``/debug/profile`` capture writes, once the file
    is complete."""
    from mmlspark_tpu_torch.utils.profiling import TRACE_FILE
    path = os.path.join(log_dir, TRACE_FILE)
    t_end = time.perf_counter() + timeout
    while time.perf_counter() < t_end:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f), os.path.getsize(path)
            except ValueError:
                pass        # still being written
        time.sleep(0.2)
    raise AssertionError(f"16c: no trace at {path} after {timeout} s")


def phase_plane_front(params_np, single, dev_info):
    """16a/16c: the generation front with the observability plane and the
    registry on. f32: phase 4's prompts, each sent ``parity_repeats``
    times with its own trace context from two tenants, give phase 4's
    tokens. bf16: phase 5's engine and mix, then every ``/debug/*`` route
    checked against the run; 16c captures ``/debug/profile`` while the mix,
    cut to ``profile_new`` tokens a request, is kept in flight (each
    request resent when answered, so prefills run all through the
    capture) and finds K1's kernels and the prefill annotation in the
    trace."""
    import torch
    from mmlspark_tpu_torch.serving.generation import GenerationEngine
    from mmlspark_tpu_torch.serving.registry import get_registry
    os.environ["MMLSPARK_TPU_TS_INTERVAL"] = str(PLANE["ts_interval"])
    _plane_reset()
    cfg32 = _full_cfg(torch.float32)
    prompts = _parity_prompts(cfg32.vocab)
    n_par = PLANE["parity_repeats"] * len(prompts)
    with GenerationEngine(params_np, cfg32, **PARITY) as eng:
        get_registry().load("gen", "1", handle=eng)
        for i in range(n_par):
            p = prompts[i % len(prompts)]
            st, hdrs, body = _post_h(
                eng.address, {"tokens": [int(t) for t in p],
                              "max_new": PARITY_NEW}, _plane_headers(i))
            if st != 200:
                raise AssertionError(f"16a f32 request {i}: {st} {body!r}")
            _echo_ok("16a f32", i, hdrs)
            got = json.loads(body)["tokens"]
            if got != single[None][i % len(prompts)]:
                raise AssertionError(f"16a f32 request {i}: {got} vs "
                                     f"phase 4's "
                                     f"{single[None][i % len(prompts)]}")
    torch.cuda.empty_cache()
    _plane_reset()

    cfg = _full_cfg(torch.bfloat16)
    max_new = 64
    payloads = _serving_payloads(cfg.vocab, max_new)
    payloads_c = _serving_payloads(cfg.vocab, PLANE["profile_new"])
    eng = GenerationEngine(params_np, cfg, max_slots=16, max_len=1024,
                           page_size=16, prefill_chunk=256,
                           steps_per_dispatch=4)
    base = f"http://127.0.0.1:{eng.server.port}"
    results = {}
    try:
        get_registry().load("gen", "1", handle=eng)
        eng.start()
        st, _ = _post(eng.address, {"tokens": [1, 2, 3], "max_new": 4})
        assert st == 200
        dec = eng.decoder
        torch.cuda.synchronize()
        dec.tick_seconds.clear()
        stats0 = dict(dec._kv.stats)
        chunks0, hits0 = len(dec._chunk_trace), dec.stats["prefix_hits"]
        _zero_pa_counts()
        wall = _plane_burst(eng, payloads, results)
        torch.cuda.synchronize()
        ticks = list(dec.tick_seconds)
        counts = _launch_split(
            "16a bf16",
            dec._kv.stats["attn_ticks_kernel"] - stats0["attn_ticks_kernel"],
            len(dec._chunk_trace) - chunks0,
            dec.stats["prefix_hits"] - hits0, cfg.layers, False)
        time.sleep(2 * PLANE["ts_interval"])   # one more sampler tick
        routes = {name: _get_json(base + path) for name, path in (
            ("slo", "/debug/slo"), ("costs", "/debug/costs"),
            ("timeseries", "/debug/timeseries?seconds=600"),
            ("healthz", "/healthz"), ("registry", "/debug/registry"),
            ("models", "/models"))}
        traces = {i: _get_json(base + f"/debug/traces/{i + 1:032x}")
                  for i in range(len(payloads))}
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        total_mem = torch.cuda.mem_get_info()[1]

        # 16c: a capture while short requests are kept in flight; a second
        # capture request meanwhile is refused
        from torch.autograd import profiler as _autograd_profiler
        st_p, prof = _get_json(
            base + f"/debug/profile?seconds={PLANE['profile_s']}")
        t_wait = time.perf_counter() + 30
        while not _autograd_profiler._is_profiler_enabled and \
                time.perf_counter() < t_wait:
            time.sleep(0.01)
        try:
            urllib.request.urlopen(base + "/debug/profile?seconds=1",
                                   timeout=60)
            second = 200
        except urllib.error.HTTPError as e:
            second = e.code
        results_c, wall_c = _plane_closed_loop(eng, payloads_c,
                                               PLANE["profile_s"])
        trace, trace_bytes = _profile_trace(prof["log_dir"])
    finally:
        eng.stop()

    # 16a: every reply 200, its trace echoed under the server's span
    n_tok = 0
    replies = [("16a", i, 0, *results.get(i, (None, {}, b"missing")))
               for i in range(len(payloads))]
    replies += [("16c", *r) for r in results_c]
    for what, i, k, status, hdrs, body in replies:
        if status != 200:
            raise AssertionError(f"{what} request {i}: {status} {body!r}")
        _echo_ok(what, i, hdrs, k)
        p = (payloads if what == "16a" else payloads_c)[i]
        toks = (_stream_tokens(body) if p.get("stream")
                else json.loads(body)["tokens"])
        if len(toks) != p["max_new"] or \
                not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"{what} request {i}: {len(toks)} tokens")
        if what == "16a":
            n_tok += len(toks)
    # the trace trees: each root carries the request's attributes; every
    # chunked prompt's chunks are events of its own trace
    chunked = 0
    for i, (st, doc) in traces.items():
        (root,) = doc["roots"]
        attrs = root["attrs"]
        if st != 200 or root["name"] != "server.request" or \
                attrs.get("model") != "gen@1" or \
                attrs.get("tenant") != f"t{i % 2}":
            raise AssertionError(f"16a trace {i}: {st} {root['name']} "
                                 f"{attrs}")
        offs = [e["fields"]["offset"] for e in root["events"]
                if e["name"] == "prefill_chunk"]
        n = len(payloads[i]["tokens"])
        want = (list(range(0, n, 256)) if n > 256
                and "prefix_key" not in payloads[i] else [])
        if offs != want:
            raise AssertionError(f"16a trace {i}: prefill_chunk offsets "
                                 f"{offs}, want {want}")
        chunked += bool(offs)
    if not chunked:
        raise AssertionError("16a: no chunked request in the mix")
    # SLO windows and costs, one class per tenant
    per_tenant = {f"t{k}": sum(1 for i in range(len(payloads))
                               if i % 2 == k) for k in (0, 1)}
    windows = {c["tenant"]: c["window"]["count"]
               for c in routes["slo"][1]["classes"]
               if c["model"] == "gen@1"}
    if windows != per_tenant:
        raise AssertionError(f"16a /debug/slo windows {windows}, want "
                             f"{per_tenant}")
    costs = {c["tenant"]: c["resources"]
             for c in routes["costs"][1]["classes"]
             if c["model"] == "gen@1"}
    if set(costs) != set(per_tenant) or not all(
            r.get("device_seconds", 0) > 0
            and r.get("kv_page_seconds", 0) > 0 for r in costs.values()):
        raise AssertionError(f"16a /debug/costs per tenant: {costs}")
    series = [s for s in routes["timeseries"][1]["series"]
              if s["name"] == "mmlspark_continuous_live_slots"]
    n_samples = sum(pt[5] for s in series for pt in s["points"])
    if n_samples < 2:
        raise AssertionError(f"16a /debug/timeseries: {n_samples} samples "
                             f"of mmlspark_continuous_live_slots")
    hbm = {k: _metric_values(metrics, f"mmlspark_device_hbm_bytes_{k}")
           for k in ("in_use", "allocated", "reserved", "limit")}
    if not all(v and all(0 < x <= total_mem for x in v.values())
               for v in hbm.values()):
        raise AssertionError(f"16a /metrics memory gauges {hbm} (card "
                             f"total {total_mem})")
    health = routes["healthz"][1]
    if health["status"] != "ok":
        raise AssertionError(f"16a /healthz: {health}")
    # 16c: the capture holds K1's kernels and the prefill annotation
    names = {e.get("name", "") for e in trace["traceEvents"]}
    k1_syms = sorted({k for n in names
                      for k in ("pa_split_kernel", "pa_mma_kernel")
                      if k in n})
    annotated = {n for n in names if n.startswith("continuous.")}
    if st_p != 200 or second != 409 or not k1_syms or \
            "continuous.prefill" not in annotated:
        raise AssertionError(f"16c: capture {st_p}, second request "
                             f"{second}, K1 symbols {k1_syms}, "
                             f"annotations {sorted(annotated)}")
    p50 = statistics.median(ticks) * 1e3 if ticks else float("nan")
    rec = {"f32_requests": n_par, "requests": len(payloads),
           "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
           "p50_tick_ms": p50, "ticks": len(ticks), "launches": counts,
           "chunked_traces": chunked, "slo_windows": windows,
           "costs": costs, "live_slot_samples": n_samples,
           "hbm_bytes": {k: max(v.values()) for k, v in hbm.items()},
           "profile": {"log_dir": prof["log_dir"], "bytes": trace_bytes,
                       "events": len(trace["traceEvents"]),
                       "k1_symbols": k1_syms,
                       "annotations": sorted(annotated),
                       "second_request": second,
                       "requests": len(results_c), "burst_wall_s": wall_c}}
    log(f"[plane front 16a/16c] f32 == phase 4's tokens over {n_par} "
        f"traced requests; {json.dumps(rec)} | {dev_info['smi']}")
    return rec


class _ShadowBodies:
    """Keeps both bodies of each joined shadow pair for 16b's numeric
    diff (the registry itself records only match/diff)."""

    def __init__(self, registry):
        self.pairs = {}
        self._inner = registry.shadow_result

        def shadow_result(primary_id, body, from_shadow):
            self.pairs.setdefault(primary_id, {})[
                "shadow" if from_shadow else "primary"] = body
            return self._inner(primary_id, body, from_shadow)
        registry.shadow_result = shadow_result


def phase_plane_engine(dev_info):
    """16b: ``ServingEngine`` over the ORT-fused BERT-base (bf16, batches
    of 32, answering each row's ``cls`` embedding) with ``bert@1`` live and
    ``bert@2`` (the same graph and weights) a canary and a shadow, both
    registered only through ``register_model``. 14b's rows go as one
    request each, all parked before the engine starts, so that each drain
    takes a full batch from the backlog (the engine's own poll timeout):
    sequences/s is the engine's over K7, not the clients' pace, and the
    record keeps the rows of each drain. The canary count is exactly the ``_bucket`` split's over
    the request ids; shadow pairs and replies agree with each other and
    with a direct ``ONNXModel.transform`` within 14b's bf16 bound; K7 runs
    12 launches a dispatched batch; promoting ``bert@2`` retires
    ``bert@1`` and frees its parameters on the card."""
    import gc
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    from mmlspark_tpu_torch.models.zoo.bert_onnx import (BertOnnxConfig,
                                                         init_bert_params)
    from mmlspark_tpu_torch.serving.engine import ServingEngine
    from mmlspark_tpu_torch.serving.registry import (ModelRegistry, _bucket,
                                                     get_registry,
                                                     set_registry)
    _plane_reset()
    cfg = BertOnnxConfig(**BERT_ONNX)
    c, pb = ONNX_BERT, PLANE_BERT
    graph = fused_bert_onnx(cfg, init_bert_params(cfg, seed=0), pooled=True)
    ids, mask = bert_rows(c["rows"], c["seq"], cfg.vocab, c["seed"])
    specs = {n: (np.int64, (c["seq"],))
             for n in ("input_ids", "attention_mask")}

    def model():
        return ONNXModel(graph, feed_dict={"input_ids": "input_ids",
                                           "attention_mask":
                                           "attention_mask"},
                         fetch_dict={"cls": "cls"},
                         mini_batch_size=c["batch"],
                         compute_dtype="bfloat16")

    direct_m = model()
    direct = direct_m.transform(DataFrame(
        {"input_ids": ids, "attention_mask": mask}))["cls"]
    del direct_m
    gc.collect()
    torch.cuda.empty_cache()
    bound = 2.0 ** -4 * float(np.abs(direct).max())
    # no canary verdict during the run (the canary count must stay
    # exact), and room for every shadow diff of the run
    set_registry(ModelRegistry(min_requests=10 ** 9,
                               shadow_keep=c["rows"]))
    registry = get_registry()
    bodies = _ShadowBodies(registry)
    eng = ServingEngine({}, schema={"input_ids": list,
                                    "attention_mask": list},
                        reply_col="cls", max_batch=c["batch"])
    drains = []
    read_batch = eng.source.read_batch

    def counted_read(max_rows, timeout):
        df = read_batch(max_rows, timeout)
        if len(df):
            drains.append(len(df))
        return df
    eng.source.read_batch = counted_read
    counters, param_bytes = {}, {}
    for v in ("1", "2"):
        m = model()
        kw = ({} if v == "1" else
              dict(canary_percent=pb["canary"], shadow_percent=pb["shadow"]))
        mv = eng.register_model(
            "bert", v, m.transform,
            warm_up=lambda m=m: m.warm_up(batch_sizes=[c["batch"]],
                                          input_specs=specs), **kw)
        if mv.state != ("live" if v == "1" else "canary"):
            raise AssertionError(f"16b: bert@{v} is {mv.state}")
        counters[v] = m.stage_counters
        counters[v].reset()
        param_bytes[v] = sum(t.numel() * t.element_size()
                             for p in m._device_params.values()
                             for t in p.values())
        del m
    base = f"http://127.0.0.1:{eng.server.port}"
    replies = {}
    _zero_k7_counts()
    try:
        def client(i):
            try:
                replies[i] = _post_h(
                    eng.address,
                    {"input_ids": ids[i].tolist(),
                     "attention_mask": mask[i].tolist()},
                    {"X-Mmlspark-Model": "bert",
                     "X-Mmlspark-Tenant": f"t{i % 2}"})
            except Exception as e:      # recorded, checked below
                replies[i] = (None, {}, repr(e).encode())

        def parked():
            """Requests parked, and the primaries among them (a shadow
            mirror is parked beside its primary)."""
            n = eng.server._queue.qsize()
            return n, n - registry.snapshot()["shadow_pending"]

        # every row parked, with the shadow mirror of each that has one,
        # four connections at a time: the listener's backlog is 5, and a
        # connection past it is reset
        threads, t_end = [], time.perf_counter() + 120
        for lo in range(0, c["rows"], 4):
            wave = [threading.Thread(target=client, args=(i,))
                    for i in range(lo, min(lo + 4, c["rows"]))]
            for t in wave:
                t.start()
            threads += wave
            while parked()[1] < len(threads):
                if replies or time.perf_counter() > t_end:
                    raise AssertionError(
                        f"16b: {parked()[1]} of {len(threads)} requests "
                        f"parked; {dict(list(replies.items())[:4])}")
                time.sleep(0.002)
        n_parked = parked()[0]
        t0 = time.perf_counter()
        eng.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        t_end = time.perf_counter() + 60
        while registry.snapshot()["shadow_pending"] and \
                time.perf_counter() < t_end:
            time.sleep(0.01)
        torch.cuda.synchronize()
        dispatched = {v: counters[v].snapshot().get(
            "dispatch", {"calls": 0})["calls"] for v in counters}
        k7 = _k7_counts("16b", cfg.layers * sum(dispatched.values()))
        snap = registry.snapshot()
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        st_pr, _, promoted = _post_h(base + "/models", {
            "action": "promote", "name": "bert", "version": "2"}, {})
        st_re, _, retired = _post_h(base + "/models", {
            "action": "retire", "name": "bert", "version": "1"}, {})
        gc.collect()
        torch.cuda.synchronize()
        freed = mem0 - torch.cuda.memory_allocated()
        _, models = _get_json(base + "/models")
    finally:
        eng.stop()
    got = np.zeros_like(direct)
    rids = []
    for i in range(c["rows"]):
        status, hdrs, body = replies.get(i, (None, {}, b"missing"))
        if status != 200:
            raise AssertionError(f"16b request {i}: {status} {body[:200]!r}")
        rids.append(hdrs["X-Request-Id"])
        got[i] = np.asarray(json.loads(body), np.float32)
    want_canary = sum(_bucket(r, "canary") < pb["canary"] for r in rids)
    by_version = {mv["version"]: mv for mv in snap["models"]["bert"]}
    if by_version["2"]["resolved_total"] != want_canary or \
            by_version["1"]["resolved_total"] != c["rows"] - want_canary:
        raise AssertionError(
            f"16b: bert@2 served {by_version['2']['resolved_total']} "
            f"requests, the split predicts {want_canary} of {c['rows']}")
    want_shadow = sum(_bucket(r, "canary") >= pb["canary"]
                      and _bucket(r, "shadow") < pb["shadow"] for r in rids)
    pairs = [p for p in bodies.pairs.values()
             if "primary" in p and "shadow" in p]
    if len(pairs) != want_shadow or len(snap["shadow_diffs"]) != \
            want_shadow:
        raise AssertionError(f"16b: {len(pairs)} shadow pairs joined, "
                             f"{len(snap['shadow_diffs'])} diffs; the "
                             f"split predicts {want_shadow}")
    shadow_err = max((float(np.abs(
        np.asarray(json.loads(p["primary"]), np.float32)
        - np.asarray(json.loads(p["shadow"]), np.float32)).max())
        for p in pairs), default=0.0)
    reply_err = float(np.abs(got - direct).max())
    if not np.isfinite(got).all() or reply_err > bound or \
            shadow_err > bound:
        raise AssertionError(f"16b: replies off the direct transform by "
                             f"{reply_err}, shadow pairs by {shadow_err} "
                             f"(bound {bound})")
    retired_body = json.loads(retired)
    states = {mv["version"]: mv["state"]
              for mv in models["models"]["bert"]}
    if st_pr != 200 or st_re != 200 or not retired_body.get("drained") \
            or states != {"1": "retired", "2": "live"} or \
            freed < 0.9 * param_bytes["1"]:
        raise AssertionError(f"16b: promote {st_pr}, retire {st_re} "
                             f"{retired_body}, states {states}, freed "
                             f"{freed} of bert@1's {param_bytes['1']} "
                             f"parameter bytes")
    verdicts = {}
    for p in pairs:
        verdicts["match" if p["primary"] == p["shadow"] else "diff"] = \
            verdicts.get("match" if p["primary"] == p["shadow"]
                         else "diff", 0) + 1
    rec = {"rows": c["rows"], "batch": c["batch"], "parked": n_parked,
           "wall_s": wall, "seq_per_s": c["rows"] / wall,
           "model_seq_per_s": (c["rows"] + len(pairs)) / wall,
           "drains": drains, "mean_drain_rows": sum(drains) / len(drains),
           "canary_requests": want_canary, "shadow_pairs": len(pairs),
           "shadow_verdicts": verdicts, "dispatched": dispatched,
           "k7_launches": k7, "reply_max_abs_err": reply_err,
           "shadow_max_abs_err": shadow_err, "bound": bound,
           "param_bytes": param_bytes["1"], "freed_bytes": freed,
           "promote": json.loads(promoted).get("promoted", {}).get("state")}
    log(f"[plane engine 16b] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


# ---- phase 17: BASELINE's image configurations #4 and #5 ------------------

#: configuration #4 (``ImageFeaturizer`` transfer learning into
#: ``LogisticRegression``) and #5 (``ImageLIME`` / ``ImageSHAP`` over the
#: featurizer), on phase 11's ResNet-50 at full width
IMAGE = dict(rows=2048, batch=512, passes=3,
             shapes=((256, 256), (240, 320)), classes=10, max_iter=200,
             parity_rows=32, explain_rows=8, num_samples=256, cell_size=16,
             seed=17)


@functools.lru_cache(maxsize=None)
def _resnet50_onnx():
    """(bench.py's seeded ResNet-50 ONNX bytes, export seconds): phase 11's
    export, made once for phases 11 and 17."""
    from mmlspark_tpu_torch.models.zoo.resnet import (RESNET50,
                                                      export_resnet_onnx)
    t0 = time.perf_counter()
    data = export_resnet_onnx(RESNET50, seed=0)
    return data, time.perf_counter() - t0


def _image_rows(n, shapes, seed):
    """n seeded uint8 BGR images, row i of shape ``shapes[i % len]`` (H,
    W): a colour, a horizontal ramp and noise each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        ramp = np.linspace(0, 1, w, dtype=np.float32)[None, :, None] * \
            rng.integers(-128, 128, 3).astype(np.float32)
        x = rng.integers(-24, 25, (h, w, 3), dtype=np.int16) + ramp + \
            rng.integers(0, 256, 3).astype(np.float32)
        out.append(np.clip(x, 0, 255).astype(np.uint8))
    return out


def _featurizer(model_bytes, dtype, cut, batch, device=None, **kw):
    from mmlspark_tpu_torch.models.featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    return ImageFeaturizer(ONNXModel(model_bytes, device=device,
                                     compute_dtype=dtype),
                           cut_output_layers=cut, input_size=224,
                           mini_batch_size=batch, **IMAGENET, **kw)


def phase_image_featurizer(dev_info, model_bytes, imgs):
    """17a: configuration #4. f32 checks first (cuDNN's heuristic
    algorithm choice), then bench timing in bf16 and the linear head."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.core.dataframe import object_col
    from mmlspark_tpu_torch.core.residency import residency_stats
    from mmlspark_tpu_torch.image import resize_uint8
    from mmlspark_tpu_torch.models.linear import LogisticRegression
    from mmlspark_tpu_torch.observability import reset_all
    cfg = IMAGE
    dev = torch.device("cuda")
    n32 = cfg["parity_rows"]
    df32 = DataFrame({"image": object_col(imgs[:n32])})

    # f32, cut_output_layers=0: the featurizer's logits against
    # ONNXModel.transform on the same rows prepped by hand (the port's
    # resize on the card one image at a time, BGR → RGB). Same card, same
    # graph and batch: bound 1e-5 of the largest |logit| (f32 sum order)
    logits = _featurizer(model_bytes, "float32", 0, n32).transform(
        df32)["features"]
    with torch.inference_mode():
        prepped = np.stack([
            resize_uint8(torch.from_numpy(im).to(dev), 224, 224)[
                ..., [2, 1, 0]].cpu().numpy() for im in imgs[:n32]])
    want = _onnx_model(model_bytes, "float32", n32).transform(
        DataFrame({"image": prepped}))["logits"]
    # f32, cut_output_layers=1: the card's features against the port on
    # the CPU (its resize too): 11a's bound, 1e-3 of the largest |feature|
    feats = _featurizer(model_bytes, "float32", 1, n32).transform(
        df32)["features"]
    cpu = _featurizer(model_bytes, "float32", 1, n32, device="cpu"
                      ).transform(df32)["features"]
    for what, a, shape in (("logits", logits, (n32, 1000)),
                           ("features", feats, (n32, 2048))):
        if a.shape != shape or not np.isfinite(a).all():
            raise AssertionError(f"17a: {what} {a.shape}, finite "
                                 f"{bool(np.isfinite(a).all())}")
    parity = {
        "rows": n32,
        "logits_vs_onnx_model": float(np.abs(logits - want).max()),
        "logits_bound": 1e-5 * float(np.abs(want).max()),
        "features_vs_cpu": float(np.abs(feats - cpu).max()),
        "features_bound": 1e-3 * float(np.abs(cpu).max()),
        "max_abs_feature": float(np.abs(feats).max())}
    if not (parity["logits_vs_onnx_model"] <= parity["logits_bound"]
            and parity["features_vs_cpu"] <= parity["features_bound"]):
        raise AssertionError(f"17a: f32 parity off: {parity}")
    log(f"[image 17a] f32 parity {json.dumps(parity)}")

    # bf16 at bench.py's batch: one untimed pass (cuDNN picks algorithms
    # per shape), then timed passes over all rows, each the two shapes'
    # ingests, the resize on the card and 4 batches of 512
    torch.backends.cudnn.benchmark = True
    feat = _featurizer(model_bytes, "bfloat16", 1, cfg["batch"])
    df = DataFrame({"image": object_col(imgs)})
    feat.transform(df)
    torch.cuda.synchronize()
    inner = feat.get("onnx_model")
    inner.stage_counters.reset()
    reset_all()
    passes, phases, out = [], [], None
    for _ in range(cfg["passes"]):
        t0 = time.perf_counter()
        out = feat.transform(df)
        passes.append(time.perf_counter() - t0)
        phases.append(feat.phase_seconds)
    stages = inner.stage_counters.snapshot()
    ingest = residency_stats()
    F = out["features"]
    if F.shape != (cfg["rows"], 2048) or not np.isfinite(F).all():
        raise AssertionError(f"17a: bf16 features {F.shape}")
    if stages["dispatch"]["calls"] != cfg["passes"] * cfg["rows"] // \
            cfg["batch"] or stages["h2d"]["bytes"] != 0:
        raise AssertionError(f"17a: runner stages {stages}")
    bf_bound = 2.0 ** -4 * float(np.abs(feats).max())
    bf_err = float(np.abs(F[:n32] - feats).max())
    if not bf_err <= bf_bound:
        raise AssertionError(f"17a: bf16 vs f32 features {bf_err} above "
                             f"{bf_bound}")

    # the head: LogisticRegression on the standardized float32 features
    # (SparkML's LogisticRegression standardizes by default; the random
    # backbone's features share a large common part that 200 Adam steps on
    # the raw column do not get past), labels from a seeded hidden linear
    # rule on them
    Z = ((F - F.mean(axis=0)) / (F.std(axis=0) + 1e-6)).astype(np.float32)
    rule = np.random.default_rng(cfg["seed"] + 1).normal(
        0, 1, (F.shape[1], cfg["classes"]))
    labels = np.argmax(Z.astype(np.float64) @ rule, axis=1)
    lr_df = DataFrame({"features": Z, "label": labels})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lr = LogisticRegression(max_iter=cfg["max_iter"]).fit(lr_df)
    fit_s = time.perf_counter() - t0
    pred = lr.transform(lr_df)["prediction"]
    acc = float((pred == labels).mean())
    if not acc > 0.9:
        raise AssertionError(f"17a: train accuracy {acc} not above 0.9")
    ips = [cfg["rows"] / p for p in passes]
    rec = {
        "rows": cfg["rows"], "batch": cfg["batch"], "dtype": "bfloat16",
        "shapes": [list(s) for s in cfg["shapes"]],
        "pass_s": passes, "images_per_s_passes": ips,
        "images_per_s": statistics.median(ips),
        "phase_seconds": phases,
        "stage_seconds": {k: v["seconds"] for k, v in stages.items()},
        "ingest_ops": ingest["h2d_ops"]["ingest"],
        "ingest_bytes": ingest["h2d_bytes"]["ingest"],
        "bf16_vs_f32": {"max_abs": bf_err, "bound": bf_bound},
        "lr": {"fit_s": fit_s, "accuracy": acc, "classes": cfg["classes"],
               "max_iter": cfg["max_iter"],
               "label_counts": np.bincount(labels).tolist()}}
    log(f"[image 17a] {json.dumps(rec)} | {dev_info['smi']}")
    return {"parity_f32": parity, "bench": rec}


def _replay_draws(draw, seg_maps, m, seed):
    """An explainer's per-row draws, replayed from its seed in row order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [draw(m, int(s.max()) + 1, rng) for s in seg_maps]


def phase_image_explainers(dev_info, model_bytes, imgs):
    """17b: configuration #5, ImageLIME and ImageSHAP over the bf16
    featurizer's logits."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame, Transformer
    from mmlspark_tpu_torch.core.dataframe import object_col
    from mmlspark_tpu_torch.explainers import ImageLIME, ImageSHAP
    from mmlspark_tpu_torch.explainers.lime import lime_states
    from mmlspark_tpu_torch.explainers.shap import _coalitions
    from mmlspark_tpu_torch.explainers.superpixel import (mask_image,
                                                          slic_superpixels)
    from mmlspark_tpu_torch.image import resize_uint8
    cfg = IMAGE
    n, m = cfg["explain_rows"], cfg["num_samples"]
    with torch.inference_mode():
        small = [resize_uint8(torch.from_numpy(im).cuda(), 224, 224)
                 .cpu().numpy() for im in imgs[:n]]
    frame = DataFrame({"image": object_col(small)})
    model = _featurizer(model_bytes, "bfloat16", 0, cfg["batch"],
                        output_col="logits")
    fx = model.transform(frame)["logits"]
    target = int(np.argmax(fx[0]))
    inner = model.get("onnx_model")

    class Recorder(Transformer):
        """The featurizer, keeping the logits of every frame it scores and
        the first row's masked samples (built on the card)."""
        logits, first = [], []

        def _transform(self, df):
            Recorder.first.append(
                df.device_column("image").device_array()[:m].cpu().numpy())
            out = model.transform(df)
            Recorder.logits.append(np.asarray(out["logits"]))
            return out

    out = {"target_class": target}
    bound_row = 2.0 ** -4 * float(np.abs(fx).max())
    for name, cls, draw, full in (("lime", ImageLIME, lime_states, 0),
                                  ("shap", ImageSHAP, _coalitions, 1)):
        kw = dict(model=Recorder(), target_col="logits",
                  target_classes=[target], num_samples=m,
                  cell_size=cfg["cell_size"])
        ex = cls(**kw)
        inner.stage_counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ex.transform(frame)
        wall = time.perf_counter() - t0
        dispatched = inner.stage_counters.snapshot()["dispatch"]["calls"]
        if dispatched != -(-n * m // cfg["batch"]):
            raise AssertionError(f"17b {name}: {dispatched} batches for "
                                 f"{n * m} samples")
        scores = Recorder.logits[-1][:, target].astype(np.float64) \
            .reshape(n, m)
        expl = [np.asarray(e) for e in res["explanation"]]
        seg_maps = list(res["superpixels"])
        # the all-on sample of each row scores the unmasked image (another
        # batch shape, so bf16: 11b's bound)
        row_err = float(np.abs(scores[:, full] - fx[:, target]).max())
        if not row_err <= bound_row:
            raise AssertionError(f"17b {name}: all-on samples {row_err} "
                                 f"from f(x), bound {bound_row}")
        # the card's segments and masks are the host's bit for bit (the
        # numpy-order float64 SLIC on the CPU; mask_image on the host for
        # the first row's samples)
        states = _replay_draws(draw, seg_maps, m, ex.get("seed"))
        if name == "lime":
            for img, seg in zip(small, seg_maps):
                if not np.array_equal(seg, slic_superpixels(
                        img, cfg["cell_size"], device="cpu")):
                    raise AssertionError("17b: the card's SLIC labels "
                                         "differ from the CPU's")
        masks = Recorder.first[-1]
        if not all(np.array_equal(masks[j], mask_image(small[0], seg_maps[0],
                                                       states[0][j]))
                   for j in range(m)):
            raise AssertionError(f"17b {name}: the card's masked samples "
                                 f"differ from mask_image's")
        # the solves again, on the card and on the CPU, from the same scores
        cpu = cls(device="cpu", **kw)
        fit = ex._fit_rows if name == "lime" else ex._solve_rows
        fit_cpu = cpu._fit_rows if name == "lime" else cpu._solve_rows
        card = fit(states, scores)
        if not all(np.array_equal(a, b) for a, b in zip(card, expl)):
            raise AssertionError(f"17b {name}: the replayed solve differs "
                                 f"from the explainer's")
        host = fit_cpu(states, scores)
        rec = {"rows": n, "num_samples": m,
               "superpixels": [int(s.max()) + 1 for s in seg_maps],
               "wall_s": wall, "s_per_image": wall / n,
               "phase_seconds": dict(ex.phase_seconds),
               "model_rows_per_s": n * m / ex.phase_seconds["score"],
               "slic_mask_share": (ex.phase_seconds["segment"]
                                   + ex.phase_seconds["sample"]) / wall,
               "model_share": ex.phase_seconds["score"] / wall,
               "batches": dispatched, "all_on_vs_fx": row_err,
               "all_on_bound": bound_row}
        if name == "lime":
            # ISTA in float32: within 1e-3 of the largest |coef|
            err = max(float(np.abs(a - b).max()) for a, b in zip(card, host))
            bound = 1e-3 * max(float(np.abs(b).max()) for b in host)
            rec["solve_card_vs_cpu"] = {"max_abs": err, "bound": bound}
        else:
            # float32 normal equations of 195 unknowns from 254 weighted
            # samples (condition ~1e4): within 1e-2 of |f(x) - base| a row
            gaps = np.abs(scores[:, 1] - scores[:, 0])
            errs = [float(np.abs(a - b).max()) for a, b in zip(card, host)]
            err = max(e / g for e, g in zip(errs, gaps))
            bound = 1e-2
            eff = [abs(float(e.sum()) - s) / float(np.abs(e).sum())
                   for e, s in zip(expl, scores[:, 1])]
            if not max(eff) <= 1e-6:
                raise AssertionError(f"17b shap: sum(phi) - f(x) {eff}")
            rec["solve_card_vs_cpu"] = {"max_abs_over_gap": err,
                                        "bound": bound}
            rec["efficiency_rel_err"] = max(eff)
        if not err <= bound:
            raise AssertionError(f"17b {name}: card vs CPU solve "
                                 f"{rec['solve_card_vs_cpu']}")
        out[name] = rec
        log(f"[image 17b] {name} {json.dumps(rec)} | {dev_info['smi']}")
    return out


def phase_image(dev_info):
    """Phases 17a and 17b."""
    import torch
    model_bytes, export_s = _resnet50_onnx()
    t0 = time.perf_counter()
    imgs = _image_rows(IMAGE["rows"], IMAGE["shapes"], IMAGE["seed"])
    log(f"[image 17] export {export_s:.2f} s, {len(imgs)} images in "
        f"{time.perf_counter() - t0:.2f} s")
    try:
        a = phase_image_featurizer(dev_info, model_bytes, imgs)
        b = phase_image_explainers(dev_info, model_bytes, imgs)
    finally:
        torch.backends.cudnn.benchmark = False
        torch.cuda.empty_cache()
    return {"17a": a, "17b": b}


# ---- phase 18: the quantized ONNX path and the converter's long tail --------

#: 18a: the QOperator ResNet-50 on phase 11b's 2048 rows in batches of 512,
#: calibrated on 4 rows on the CPU, 8 rows' codes held to the CPU, 32 rows'
#: argmax to the float graph in f32 (phase 11a's)
QRESNET = dict(rows=2048, batch=512, passes=3, calib_rows=4, code_rows=8,
               argmax_rows=32, argmax_share=0.9)
#: 18b: 14b's fused BERT-base with quantize="int8", bf16, its 256 rows;
#: the hidden states within 2^-4 of the largest unquantized |hidden| (2^-3
#: at first, tightened after a run read 0.034 on an NVIDIA H100 80GB HBM3
#: at 700 W; the CPU test's small BERT reads 0.0057 in f32)
QBERT = dict(hidden_bound=2.0 ** -4)


def onnx_op_cases():
    """One-node graphs (a body each for Loop and Scan) of every handler the
    port took over from the reference's ``onnx/convert.py`` in its
    control-flow, recurrent, resampling, detection and long-tail groups, at
    the shapes ``tests/test_torch_onnx_ops.py`` uses; Loop, Scan, LSTM and
    GRU at T = 64. {name: (model bytes, feeds, exact)}: ``exact`` marks
    float outputs that are only moved (bitwise on any device)."""
    import numpy as np
    from mmlspark_tpu_torch.onnx.builder import (make_graph, make_model,
                                                 make_node,
                                                 make_tensor_value_info as vi)
    g = np.random.default_rng(18)

    def r(*shape, s=1.0):
        return g.normal(0, s, shape).astype(np.float32)

    def one(op, feeds, inits=None, ins=None, outs=("y",), opset=17,
            exact=False, **attrs):
        nodes = [make_node(op, list(ins or feeds), list(outs), **attrs)]
        return graph(nodes, feeds, inits, outs, opset, exact)

    def graph(nodes, feeds, inits=None, outs=("y",), opset=17, exact=False):
        gr = make_graph(nodes, "t", [vi(k, v.dtype, list(v.shape))
                                     for k, v in feeds.items()],
                        [vi(o, np.float32, []) for o in outs],
                        initializers=inits or {})
        return (make_model(gr, opset=opset,
                           extra_opsets={"com.microsoft": 1}), feeds, exact)

    ms = {"domain": "com.microsoft"}
    x = r(3, 4, 5)
    xa = np.concatenate([x.ravel() * 4, [-2.0, -0.3, 0.0, 0.4, 2.0, 30.0]]) \
        .astype(np.float32)
    cases = {}
    for op, attrs in (("LeakyRelu", dict(alpha=0.1)),
                      ("Elu", dict(alpha=0.7)), ("Selu", {}),
                      ("Celu", dict(alpha=1.3)), ("Softplus", {}),
                      ("HardSigmoid", dict(alpha=0.3, beta=0.4)),
                      ("HardSwish", {}), ("Shrink", dict(lambd=0.5, bias=0.1)),
                      ("ThresholdedRelu", dict(alpha=0.5))):
        cases[op] = one(op, {"x": xa}, **attrs)
    cases["PRelu"] = one("PRelu", {"x": r(2, 4, 3, 5)},
                         {"slope": np.abs(r(4, 1, 1)) * 0.3},
                         ins=["x", "slope"])
    cases["CastLike"] = one("CastLike", {"x": x * 10,
                                         "t": np.zeros(1, np.int32)})
    cases["BitShift"] = one("BitShift", {
        "x": g.integers(0, 2 ** 32 - 1, 16).astype(np.uint32),
        "s": g.integers(0, 32, 16).astype(np.uint32)}, direction="LEFT")
    cases["ReverseSequence"] = one(
        "ReverseSequence", {"x": x, "l": np.array([4, 1, 3], np.int64)},
        batch_axis=0, time_axis=1, exact=True)
    cases["GatherElements"] = one("GatherElements", {
        "x": x, "i": g.integers(-4, 4, (3, 6, 5)).astype(np.int64)},
        axis=1, exact=True)
    cases["GatherND"] = one("GatherND", {
        "x": x, "i": np.array([[0, 1], [2, -1]], np.int64)}, exact=True)
    cases["ScatterND"] = one("ScatterND", {
        "x": x, "i": np.array([[0, 1, 2], [2, 3, 4], [1, 0, 0]], np.int64),
        "u": r(3)}, exact=True)
    cases["TopK"] = one("TopK", {"x": g.integers(0, 4, (3, 6, 7))
                                 .astype(np.float32)},
                        {"k": np.array([3], np.int64)}, ins=["x", "k"],
                        outs=("v", "i"), exact=True)
    cases["OneHot"] = one("OneHot", {"i": np.array([[0, 4, -1], [2, 7, -6]],
                                                   np.int64)},
                          {"d": np.array(5, np.int64),
                           "v": np.array([0.0, 3.0], np.float32)},
                          ins=["i", "d", "v"], axis=0)
    cases["CumSum"] = one("CumSum", {"x": x}, {"a": np.array(1, np.int64)},
                          ins=["x", "a"], exclusive=1, reverse=1)
    cases["Trilu"] = one("Trilu", {"x": x}, {"k": np.array(-1, np.int64)},
                         ins=["x", "k"], upper=0, exact=True)
    cases["EyeLike"] = one("EyeLike", {"x": x[0]}, k=1, exact=True)
    cases["DepthToSpace"] = one("DepthToSpace", {"x": r(2, 8, 3, 4)},
                                blocksize=2, mode="CRD", exact=True)
    cases["SpaceToDepth"] = one("SpaceToDepth", {"x": r(2, 3, 4, 6)},
                                blocksize=2, exact=True)
    cases["ConvTranspose"] = one(
        "ConvTranspose", {"x": r(2, 3, 5, 6)}, {"w": r(3, 4, 3, 3),
                                                 "b": r(4)},
        ins=["x", "w", "b"], strides=[2, 1], dilations=[1, 2],
        pads=[0, 1, 2, 0], output_padding=[1, 0])
    cases["FusedConv"] = one(
        "FusedConv", {"x": r(1, 3, 8, 8)}, {"w": r(4, 3, 3, 3, s=0.3),
                                            "b": r(4, s=0.1),
                                            "z": r(1, 4, 6, 6)},
        ins=["x", "w", "b", "z"], activation="LeakyRelu",
        activation_params=[0.2], **ms)
    cases["InstanceNormalization"] = one(
        "InstanceNormalization", {"x": r(2, 3, 4, 5) * 3 + 1},
        {"s": r(3), "b": r(3)}, ins=["x", "s", "b"], epsilon=1e-4)
    cases["GroupNormalization"] = one(
        "GroupNormalization", {"x": r(2, 4, 3, 5) * 2 - 1},
        {"s": r(4), "b": r(4)}, ins=["x", "s", "b"], num_groups=2, opset=18)
    cases["LpNormalization"] = one("LpNormalization", {"x": x}, p=1, axis=1)
    cases["ReduceLogSum"] = one("ReduceLogSum", {"x": np.abs(r(3, 4)) + 0.5},
                                axes=[1], opset=13)
    img = r(2, 3, 6, 5) * 50 + 100
    for mode, sizes in (("nearest", [2, 3, 11, 9]), ("linear", [2, 3, 3, 2]),
                        ("cubic", [2, 3, 12, 10])):
        cases[f"Resize {mode}"] = one(
            "Resize", {"x": img}, {"sz": np.array(sizes, np.int64)},
            ins=["x", "", "", "sz"], mode=mode, exact=mode == "nearest")
    cases["Upsample"] = graph(
        [make_node("Constant", [], ["s"],
                   value=np.array([1.0, 1.0, 2.0, 3.0], np.float32)),
         make_node("Upsample", ["x", "s"], ["y"], mode="linear")],
        {"x": r(1, 2, 5, 4)}, opset=9)
    corners = g.uniform(0, 20, (2, 30, 2)).astype(np.float32)
    boxes = np.concatenate([corners, corners + g.uniform(
        1, 8, (2, 30, 2)).astype(np.float32)], axis=-1)
    cases["NonMaxSuppression"] = one(
        "NonMaxSuppression", {"b": boxes, "s": g.uniform(0, 1, (2, 3, 30))
                              .astype(np.float32)},
        {"m": np.int64(7), "i": np.float32(0.3), "t": np.float32(0.2)},
        ins=["b", "s", "m", "i", "t"])
    cases["RoiAlign"] = one(
        "RoiAlign", {"x": r(2, 3, 16, 16),
                     "r": np.asarray([[1.0, 2.0, 9.0, 12.0],
                                      [0.0, 0.0, 16.0, 16.0],
                                      [-3.0, 5.0, 30.0, 18.0]], np.float32),
                     "bi": np.asarray([1, 0, 1], np.int64)},
        output_height=4, output_width=3, sampling_ratio=2, spatial_scale=0.5)
    for mode, pad in (("bilinear", "reflection"), ("nearest", "zeros")):
        cases[f"GridSample {mode}"] = one(
            "GridSample", {"x": r(2, 3, 7, 9),
                           "g": g.uniform(-1.3, 1.3, (2, 5, 6, 2))
                           .astype(np.float32)},
            mode=mode, padding_mode=pad, exact=mode == "nearest")
    then_g = make_graph([make_node("Mul", ["x", "two"], ["y"])], "then", [],
                        [vi("y", np.float32, [3])],
                        initializers={"two": np.float32(2.0).reshape(())})
    else_g = make_graph([make_node("Neg", ["x"], ["y"])], "else", [],
                        [vi("y", np.float32, [3])])
    cases["If"] = one("If", {"cond": np.asarray(False),
                             "x": np.array([1.0, 2.0, 3.0], np.float32)},
                      ins=["cond"], then_branch=then_g, else_branch=else_g,
                      exact=True)
    T = 64
    body = make_graph(
        [make_node("Add", ["v_in", "x"], ["v_add"]),
         make_node("Mul", ["v_add", "decay"], ["v_out"]),
         make_node("Less", ["iter", "stop"], ["cond_out"]),
         make_node("Identity", ["v_out"], ["unused"])], "body",
        [vi("iter", np.int64, []), vi("cond_in", np.bool_, []),
         vi("v_in", np.float32, [4])],
        [vi("cond_out", np.bool_, []), vi("v_out", np.float32, [4])],
        initializers={"decay": np.float32(0.97).reshape(()),
                      "stop": np.int64(T - 9).reshape(())})
    cases["Loop"] = one("Loop", {"v0": r(4), "x": r(4)},
                        {"M": np.int64(T).reshape(())},
                        ins=["M", "", "v0"], body=body)
    sbody = make_graph(
        [make_node("Add", ["s_in", "x_t"], ["s_out"]),
         make_node("Tanh", ["s_out"], ["y_t"])], "body",
        [vi("s_in", np.float32, [3]), vi("x_t", np.float32, [3])],
        [vi("s_out", np.float32, [3]), vi("y_t", np.float32, [3])])
    cases["Scan"] = one("Scan", {"s0": r(3), "xs": r(T, 3, s=0.3)},
                        outs=("s_final", "ys"), body=sbody,
                        num_scan_inputs=1)
    Bt, I, H = 4, 16, 32
    for op, gates, attrs in (("LSTM", 4, dict(direction="bidirectional")),
                             ("GRU", 3, dict(linear_before_reset=0))):
        dirs = 2 if attrs.get("direction") == "bidirectional" else 1
        cases[op] = one(
            op, {"X": r(T, Bt, I)},
            {"W": r(dirs, gates * H, I, s=0.3),
             "R": r(dirs, gates * H, H, s=0.3),
             "B": r(dirs, 2 * gates * H, s=0.1)},
            ins=["X", "W", "R", "B"],
            outs=("Y", "Y_h") + (("Y_c",) if op == "LSTM" else ()),
            hidden_size=H, **attrs)
    return cases


def ml_op_cases():
    """One-node graphs of the 14 ai.onnx.ml-family handlers that are not
    tree ensembles (``onnx/ml_ops.py``), at the shapes
    ``tests/test_torch_onnx_ml_ops.py`` uses. {name: (model bytes, feeds,
    exact)}: ``exact`` marks float outputs that are only moved or
    selected (bitwise on any device)."""
    import numpy as np
    from mmlspark_tpu_torch.onnx.builder import (make_graph, make_model,
                                                 make_node,
                                                 make_tensor_value_info as vi)
    g = np.random.default_rng(19)

    def r(*shape, s=1.0):
        return g.normal(0, s, shape).astype(np.float32)

    def one(op, feeds, inits=None, outs=("y",), exact=False, ml=True,
            **attrs):
        node = make_node(op, list(feeds) + list(inits or {}), list(outs),
                         domain="ai.onnx.ml" if ml else "", **attrs)
        gr = make_graph([node], "t", [vi(k, v.dtype, list(v.shape))
                                      for k, v in feeds.items()],
                        [vi(o, np.float32, []) for o in outs],
                        initializers=inits or {})
        return (make_model(gr, opset=17, extra_opsets={"ai.onnx.ml": 3}),
                feeds, exact)

    x = r(6, 5)
    xn = x.copy()
    xn[::2, 1] = np.nan
    sv = r(4, 5)
    return {
        "LinearClassifier": one(
            "LinearClassifier", {"x": x}, outs=("label", "scores"),
            coefficients=r(3, 5).ravel().tolist(),
            intercepts=r(3).tolist(), classlabels_ints=[4, 5, 6],
            post_transform="SOFTMAX"),
        "LinearRegressor": one(
            "LinearRegressor", {"x": x}, coefficients=r(2, 5).ravel()
            .tolist(), intercepts=[0.5, -0.25], targets=2),
        "Scaler": one("Scaler", {"x": x}, offset=r(5).tolist(),
                      scale=r(5).tolist()),
        "Normalizer": one("Normalizer", {"x": x}, norm="L2"),
        "Imputer": one("Imputer", {"x": xn}, exact=True,
                       imputed_value_floats=r(5).tolist()),
        "Binarizer": one("Binarizer", {"x": x}, threshold=0.1),
        "ArrayFeatureExtractor": one(
            "ArrayFeatureExtractor", {"x": x},
            {"idx": np.array([4, 0, 2], np.int64)}, exact=True),
        "FeatureVectorizer": one(
            "FeatureVectorizer", {"a": x[:, :1].copy(), "b": x[:, 1:].copy()},
            exact=True, inputdimensions=[1, 4]),
        "LabelEncoder": one(
            "LabelEncoder", {"x": np.array([5, 7, 9, 7, 11], np.int64)},
            keys_int64s=[5, 7, 11], values_floats=[0.5, 0.7, 1.1],
            default_float=-1.0, exact=True),
        "ZipMap": one("ZipMap", {"x": x}, exact=True,
                      classlabels_int64s=[0, 1, 2, 3, 4]),
        "SVMRegressor": one(
            "SVMRegressor", {"x": x}, coefficients=r(4).tolist(),
            support_vectors=sv.ravel().tolist(), rho=[0.3],
            kernel_type="RBF", kernel_params=[0.4, 0.0, 3.0]),
        "SVMClassifier": one(
            "SVMClassifier", {"x": x}, outs=("label", "scores"),
            classlabels_ints=[0, 1, 2], vectors_per_class=[1, 2, 1],
            support_vectors=sv.ravel().tolist(),
            coefficients=r(2, 4).ravel().tolist(), rho=r(3).tolist(),
            kernel_type="POLY", kernel_params=[0.5, 1.0, 2.0]),
        "Hardmax": one("Hardmax", {"x": np.array(
            [[1.0, 3.0, 3.0], [2.0, 0.0, -1.0]], np.float32)}, ml=False,
            exact=True),
        "ScatterElements": one(
            "ScatterElements", {"data": r(3, 4)},
            {"idx": np.array([[0, -1], [2, 1]], np.int64),
             "upd": r(2, 2)}, ml=False, exact=True, axis=1,
            reduction="add"),
    }


def phase_onnx_ops(dev_info, cases=None, what="18c"):
    """18c: every case of ``onnx_op_cases`` (or of ``cases``, a dict of
    the same form) on the card (params and feeds as CUDA tensors) against
    the port on the CPU: integer outputs and moved data bitwise, floats
    within 1e-5 * max|ref| + 1e-6."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.onnx import convert_model
    dev = torch.device("cuda")
    rec = {}
    for name, (data, feeds, exact) in (cases or onnx_op_cases()).items():
        cm = convert_model(data)
        t0 = time.perf_counter()
        card = cm({k: torch.from_numpy(v).to(dev)
                   for k, v in cm.params.items()},
                  {k: torch.from_numpy(np.array(v)).to(dev)
                   for k, v in feeds.items()})
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        cpu = cm({k: torch.from_numpy(v) for k, v in cm.params.items()},
                 {k: torch.from_numpy(np.array(v)) for k, v in feeds.items()})
        errs = {}
        for o, want in cpu.items():
            got, want = card[o].cpu().numpy(), want.numpy()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{what} {name}: {o} {got.shape} "
                                     f"{got.dtype}, CPU {want.shape} "
                                     f"{want.dtype}")
            if want.dtype.kind != "f" or exact:
                if not np.array_equal(got, want):
                    raise AssertionError(f"{what} {name}: {o} not bitwise the "
                                         f"CPU's")
                errs[o] = 0.0
                continue
            tol = 1e-5 * float(np.abs(want).max(initial=0.0)) + 1e-6
            errs[o] = float(np.abs(got.astype(np.float64) - want)
                            .max(initial=0.0))
            if not (np.isfinite(got).all() and errs[o] <= tol):
                raise AssertionError(f"{what} {name}: {o} off the CPU by "
                                     f"{errs[o]} (bound {tol})")
        rec[name] = {"max_abs_err": max(errs.values()), "card_ms": card_ms}
    log(f"[onnx ops {what}] {len(rec)} graphs on the card held to the CPU: "
        f"{json.dumps(rec)}")
    return rec


def _prep_images(X):
    """Phase 11's input prep on the CPU, as ``ONNXModel``'s: NHWC uint8 →
    NCHW float32, * scale, - mean, / std."""
    import torch
    x = torch.from_numpy(X).permute(0, 3, 1, 2).to(torch.float32)
    shape = (1, -1, 1, 1)
    x = x * torch.tensor(IMAGENET["scale"], dtype=torch.float32)
    x = x - torch.tensor(IMAGENET["mean"]).reshape(shape)
    return x / torch.tensor(IMAGENET["std"]).reshape(shape)


def _graph_env(cm, params, x):
    """Every tensor of ``cm`` on the batch ``x`` with ``params`` (on
    ``x``'s device)."""
    import torch
    from mmlspark_tpu_torch.onnx.convert import _Ctx, _eval_nodes
    env = {**cm.const_params, **params, cm.input_names[0]: x, "": None}
    with torch.inference_mode():
        _eval_nodes(cm.model.graph.nodes, env, _Ctx(cm.model.opset,
                                                    x.device))
    return env


def _passes(m, df, passes, col="logits"):
    """One untimed transform, then ``passes`` timed ones: (rows/s median,
    pass seconds, the last output column)."""
    import torch
    m.transform(df)
    torch.cuda.synchronize()
    times, out = [], None
    for _ in range(passes):
        t0 = time.perf_counter()
        out = m.transform(df)[col]
        times.append(time.perf_counter() - t0)
    return len(df) / statistics.median(times), times, out


def phase_quant_resnet(dev_info):
    """18a: the QOperator ResNet-50 through ``DataFrame`` →
    ``ONNXModel(device=None, compute_dtype="float32").transform``."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    dev = torch.device("cuda")
    c = QRESNET
    model_bytes, _ = _resnet50_onnx()
    X = np.random.default_rng(0).integers(0, 256, (c["rows"], 224, 224, 3),
                                          dtype=np.uint8)
    t0 = time.perf_counter()
    qbytes = qoperator_resnet_onnx(model_bytes,
                                   _prep_images(X[:c["calib_rows"]]))
    build_s = time.perf_counter() - t0
    convs = qlinear_conv_outputs(qbytes)
    batch = c["batch"]
    q = _onnx_model(qbytes, "float32", batch)
    cm = q._ensure_converted()

    # every QLinearConv output code of 8 rows, card against CPU, and the
    # logits of those rows through transform on both
    n8 = c["code_rows"]
    x8 = _prep_images(X[:n8])
    t0 = time.perf_counter()
    cpu_env = _graph_env(cm, {k: torch.from_numpy(v)
                              for k, v in cm.params.items()}, x8)
    cpu_s = time.perf_counter() - t0
    card_env = _graph_env(cm, q._params_for_device(dev), x8.to(dev))
    for name in convs:
        got, want = card_env[name].cpu(), cpu_env[name]
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"18a: QLinearConv {name} codes differ "
                                 f"between the card and the CPU")
    del cpu_env, card_env
    cpu_logits = _onnx_model(qbytes, "float32", n8, device="cpu").transform(
        DataFrame({"image": X[:n8]}))["logits"]
    card8 = q.transform(DataFrame({"image": X[:n8]}))["logits"]
    logit_err = float(np.abs(card8 - cpu_logits).max())
    logit_bound = 1e-6 * float(np.abs(cpu_logits).max())
    if not logit_err <= logit_bound:
        raise AssertionError(f"18a: logits off the CPU by {logit_err} "
                             f"(bound {logit_bound})")

    # argmax against phase 11a's f32 float graph on 32 rows
    n32 = c["argmax_rows"]
    f32 = _onnx_model(model_bytes, "float32", n32).transform(
        DataFrame({"image": X[:n32]}))["logits"]
    q32 = q.transform(DataFrame({"image": X[:n32]}))
    agree = float((q32["pred"] == f32.argmax(1)).mean())
    rel = float(np.abs(q32["logits"] - f32).max() / np.abs(f32).max())
    if not (np.isfinite(q32["logits"]).all()
            and agree >= c["argmax_share"]):
        raise AssertionError(f"18a: argmax agrees with the f32 float graph "
                             f"on {agree:.3f} of {n32} rows (want >= "
                             f"{c['argmax_share']})")

    # images/s, host-fed as 11b, beside the float graph in bf16 (11b's
    # configuration) in this run
    col = np.empty(c["rows"], dtype=object)
    for i in range(c["rows"]):
        col[i] = X[i]
    df = DataFrame({"image": col})
    spec = {"input": (np.uint8, (224, 224, 3))}
    torch.backends.cudnn.benchmark = True
    try:
        q.warm_up(batch_sizes=[batch], input_specs=spec)
        q_ips, q_times, logits = _passes(q, df, c["passes"])
        fl = _onnx_model(model_bytes, "bfloat16", batch)
        fl.warm_up(batch_sizes=[batch], input_specs=spec)
        f_ips, f_times, _ = _passes(fl, df, c["passes"])
        if logits.shape != (c["rows"], f32.shape[1]) or \
                not np.isfinite(logits).all():
            raise AssertionError(f"18a: logits {logits.shape} or not finite")
        # one batch of 512 on the card (uint8 resident), CUDA events
        x512 = torch.from_numpy(X[:batch]).to(dev)
        with torch.inference_mode():
            fns = {"int8_qoperator_f32": (q._ensure_fn(),
                                          q._params_for_device(dev)),
                   "float_bf16": (fl._ensure_fn(),
                                  fl._params_for_device(dev))}
            batch_ms = {k: _cuda_ms([lambda f=f, p=p: f(p, {"input": x512})],
                                    3) for k, (f, p) in fns.items()}
            host_ms = {k: _host_ms([lambda f=f, p=p: f(p, {"input": x512})],
                                   2) for k, (f, p) in fns.items()}
    finally:
        torch.backends.cudnn.benchmark = False
    rec = {"rows": c["rows"], "batch": batch, "build_s": build_s,
           "qlinear_convs": len(convs), "code_rows": n8,
           "codes_bitwise_cpu": True, "cpu_graph_s": cpu_s,
           "logits_vs_cpu": logit_err, "logits_bound": logit_bound,
           "argmax_rows": n32, "argmax_agree_f32_float": agree,
           "max_rel_logit_vs_f32_float": rel,
           "images_per_s": q_ips, "pass_s": q_times,
           "float_bf16_images_per_s": f_ips, "float_bf16_pass_s": f_times,
           "batch_device_ms": batch_ms, "batch_host_ms": host_ms,
           "accumulation": "float64 on the card: F.conv2d (cuDNN) for "
                           "QLinearConv, torch.matmul (cuBLAS DGEMM) for "
                           "QGemm, rounded to the integer"}
    log(f"[quant 18a] {json.dumps(rec)} | {dev_info['smi']}")
    del q, fl, x512, fns
    torch.cuda.empty_cache()
    return rec


def phase_quant_bert(dev_info):
    """18b: 14b's fused BERT-base with ``quantize="int8"`` in bf16 beside
    the same graph unquantized, in this run."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.zoo.bert_onnx import (BertOnnxConfig,
                                                         init_bert_params)
    dev = torch.device("cuda")
    cfg = BertOnnxConfig(**BERT_ONNX)
    c = ONNX_BERT
    graph = fused_bert_onnx(cfg, init_bert_params(cfg, seed=0))
    ids, mask = bert_rows(c["rows"], c["seq"], cfg.vocab, c["seed"])
    df = DataFrame({"input_ids": ids, "attention_mask": mask})
    want = cfg.layers * -(-c["rows"] // c["batch"]) * c["passes"]
    specs = {n: (np.int64, (c["seq"],))
             for n in ("input_ids", "attention_mask")}
    # both parameter caches first, each on an allocator emptied of cached
    # blocks: a cached block it hands out whole would count as parameter
    # bytes
    models, params, param_bytes = {}, {}, {}
    for name, kw in (("bf16", {}), ("int8", {"quantize": "int8"})):
        models[name] = _bert_model(graph, "bfloat16", c["batch"], **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        params[name] = models[name]._params_for_device(dev)
        torch.cuda.synchronize()
        param_bytes[name] = torch.cuda.memory_allocated() - before
    runs = {}
    for name, m in models.items():
        warm = m.warm_up(batch_sizes=[c["batch"]], input_specs=specs)
        m.transform(df)
        _zero_k7_counts()
        sps, times, hidden = _bert_passes(m, df, c["passes"])
        runs[name] = {"seq_per_s": sps, "pass_s": times, "warm_up": warm,
                      "param_bytes": param_bytes[name],
                      "k7_launches": _k7_counts(f"18b {name}", want),
                      "hidden": hidden,
                      **_bert_batch_fn_ms(m, ids[:c["batch"]],
                                          mask[:c["batch"]])}
    del models, m
    h0, hq = runs["bf16"].pop("hidden"), runs["int8"].pop("hidden")
    ref = float(np.abs(h0).max())
    err = float(np.abs(hq - h0).max())
    bound = QBERT["hidden_bound"] * ref
    if not (np.isfinite(hq).all() and err <= bound):
        raise AssertionError(f"18b: int8 hidden off the bf16 run by {err} "
                             f"(bound {bound}) or not finite")
    packed = [k for k, v in params["int8"].items() if isinstance(v, dict)]
    bf16_bytes = sum(params["bf16"][k].numel() * 2 for k in packed)
    code_bytes = sum(params["int8"][k]["q"].numel()
                     + params["int8"][k]["s"].numel() * 4 for k in packed)
    # the tensors themselves: one byte a value and a float32 scale a
    # column, against bf16's two bytes a value
    rows = min(params["int8"][k]["q"].shape[0] for k in packed)
    if not code_bytes <= (0.5 + 2.0 / rows) * bf16_bytes:
        raise AssertionError(f"18b: the packed tensors hold {code_bytes} "
                             f"bytes against {bf16_bytes} in bf16")
    # the allocator's view: the quantized cache less the tensors both
    # caches hold alike (the unpacked ones). The caching allocator rounds
    # each block up to 512 bytes and gives a request above 1 MiB a cached
    # block up to 1 MiB larger without splitting it
    packed_bytes = runs["int8"]["param_bytes"] - (
        runs["bf16"]["param_bytes"] - bf16_bytes)
    blocks = len(params["int8"]) + len(packed)
    large = sum(params["int8"][k]["q"].nbytes > 1 << 20 for k in packed)
    slack = 512 * blocks + (1 << 20) * large
    ratio = packed_bytes / bf16_bytes
    if not packed_bytes <= code_bytes + slack:
        raise AssertionError(f"18b: packed matrices hold {packed_bytes} "
                             f"bytes on the card ({ratio:.4f} of their bf16 "
                             f"{bf16_bytes}), above their {code_bytes} "
                             f"bytes and the allocator's {slack}")
    rec = {"rows": c["rows"], "batch": c["batch"], "bf16": runs["bf16"],
           "int8": runs["int8"], "max_abs_hidden_bf16": ref,
           "max_abs_int8_vs_bf16": err, "rel_int8_vs_bf16": err / ref,
           "hidden_bound": bound, "packed_matrices": len(packed),
           "packed_bf16_bytes": bf16_bytes, "packed_bytes": packed_bytes,
           "packed_code_and_scale_bytes": code_bytes,
           "allocator_slack_bound": slack,
           "packed_ratio_of_bf16": ratio,
           "packed_ratio_of_f32": packed_bytes / (2 * bf16_bytes)}
    log(f"[quant 18b] {json.dumps(rec)} | {dev_info['smi']}")
    del params
    torch.cuda.empty_cache()
    return rec


#: phase 19: BASELINE #2 (8c's HIGGS-shaped 11M x 28, 8c's params) past
#: ``fit``; 19b at 12b's Covertype shape and on 1M HIGGS rows
AFTERFIT = dict(rows=2_750_000, iters=50, shap_rows=65_536,
                shap_cpu_rows=1_024, onnx_rows=1_000_000, onnx_batch=65_536,
                refit_rows=(1_750_000, 2_750_000), refit_cpu_rows=100_000,
                multi_iters=20, multi_shap_rows=8_192, multi_onnx_rows=131_072,
                multi_init_iters=5, reg_rows=1_000_000, reg_iters=20)


def _k6_19(what, iters, launches):
    """Phase 19's fits: :func:`_check_counts`, recorded under ``what``."""
    launches[what] = _check_counts(f"19 {what}", iters)
    return launches[what]


def _same_arrays(what, a, b, names):
    import numpy as np
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: {name} differs")


def _shap_additive(what, phi, raw):
    """Sum of the contributions and the expected value against the margin:
    within 1e-5 * (1 + |margin|) on every row. Returns the worst ratio of
    the gap to its bound."""
    import numpy as np
    total = phi.astype(np.float64).sum(axis=-1)
    gap = np.abs(total - raw) / (1e-5 * (1 + np.abs(raw)))
    if not np.isfinite(total).all() or gap.max() > 1.0:
        raise AssertionError(f"{what}: SHAP sums off the margin by "
                             f"{gap.max()} of the bound")
    return float(gap.max())


def _shap_launches(booster, X):
    """Kernel launches of one ``shap_values`` call and its seconds under
    the profiler: the runtime's launch calls, as :func:`_kernel_launches`
    counts them, read off the raw events (``key_averages`` builds an
    object for each)."""
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            booster.shap_values(X)
            torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = sum(1 for e in prof.profiler.kineto_results.events()
                   if "LaunchKernel" in e.name())
    return launches, secs


def _onnx_rows(model_bytes, X, fetch, batch):
    """``ONNXModel(device=None, compute_dtype="float32")`` over ``X`` as a
    ``features`` column: one untimed transform of a batch, then the timed
    one. Returns (output frame, rows/s, h2d bytes of the timed pass)."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    import torch
    m = ONNXModel(model_bytes, device=None, compute_dtype="float32",
                  mini_batch_size=batch,
                  feed_dict={"features": "features"}, fetch_dict=fetch)
    m.transform(DataFrame({"features": X[:batch]}))
    torch.cuda.synchronize()
    m.stage_counters.reset()
    t0 = time.perf_counter()
    out = m.transform(DataFrame({"features": X}))
    secs = time.perf_counter() - t0
    snap = m.stage_counters.snapshot()
    return out, len(X) / secs, snap.get("h2d", {}).get("bytes", 0), secs


def _padded_feature_bytes(n, batch, width):
    from mmlspark_tpu_torch.ops.padding import bucket_size
    full, rest = divmod(n, batch)
    rows = full * bucket_size(batch) + (bucket_size(rest) if rest else 0)
    return rows * width * 4


def phase_afterfit_higgs(dev_info):
    """19a: BASELINE #2 past ``fit`` (see the module docstring)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.gbdt import (Booster, BinMapper,
                                                LightGBMClassifier)
    from mmlspark_tpu_torch.models.gbdt.objectives import get_objective
    from mmlspark_tpu_torch.models.gbdt.train import bins_on_device
    from mmlspark_tpu_torch.models.gbdt.trees import build_tree
    cfg = AFTERFIT
    iters = cfg["iters"]
    X, y = make_higgs_like(GBDT["rows"], GBDT["features"])
    X, y = X[:cfg["rows"]], y[:cfg["rows"]]
    df = DataFrame({"features": X, "label": y})
    params = dict(num_leaves=31, max_bin=255, learning_rate=0.1,
                  min_data_in_leaf=20, num_iterations=iters)
    launches, secs = {}, {}
    # 1. fit A
    _zero_launch_counts()
    t0 = time.perf_counter()
    A = LightGBMClassifier(**params).fit(df)
    secs["fit_a"] = time.perf_counter() - t0
    _k6_19("fit_a", iters, launches)
    bA = A.booster
    # 2. the warm start: B continues A's model string
    _zero_launch_counts()
    t0 = time.perf_counter()
    B = LightGBMClassifier(model_string=bA.to_string(), **params).fit(df)
    secs["warm_start_b"] = time.perf_counter() - t0
    _k6_19("warm_start_b", iters, launches)
    bB = B.booster
    if bB.num_trees != 2 * iters or bB.best_iteration != 2 * iters:
        raise AssertionError(f"19a B: {bB.num_trees} trees, best_iteration "
                             f"{bB.best_iteration}")
    _same_arrays("19a B's first trees against A", bB.truncated(iters), bA,
                 ("feats", "thr_raw", "leaf_values", "gains", "covers"))
    # B's first new tree at A's scores, through K6 and the plain version
    dev = bB.device
    mapper = BinMapper(max_bin=255, seed=0).fit(X)
    bins = bins_on_device(mapper, X, dev)[0]
    obj = get_objective("binary")
    base = torch.tensor(bA.base_score, dtype=torch.float32, device=dev)
    scores = bA.raw_score_on_device(X) - base
    y_d = torch.as_tensor(y, dtype=torch.float32).to(dev)
    live = torch.ones(len(y), dtype=torch.float32, device=dev)
    g, h = obj.grad_hess(scores + base, y_d, live)
    kw = dict(depth=5, n_bins=mapper.n_bins, lam=1e-10, alpha=0.0,
              min_gain=0.0, min_child_weight=1e-3, min_data_in_leaf=20.0)
    outs = {impl: [t.cpu().numpy() for t in build_tree(
        bins, g, h, live, hist_impl=impl, **kw)]
        for impl in ("kernel", "plain")}
    (fk, tk, _, _, gk, _), (fp, tp, _, _, gp, _) = (outs["kernel"],
                                                    outs["plain"])
    first_ties = _tree_ties("19a B's first new tree", (fk, tk, gk),
                            (fp, tp, gp))
    first_equals_b = bool(np.array_equal(fk, bB.feats[iters]))
    del bins, scores, g, h, y_d, live
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pA, pB = bA.predict(X), bB.predict(X)
    secs["predict_a_b"] = time.perf_counter() - t0
    auc_a, auc_b = _auc(y, pA), _auc(y, pB)
    if not auc_b >= auc_a:
        raise AssertionError(f"19a: train AUC of B {auc_b} below A's {auc_a}")
    # 3. init_score: C starts from A's raw margins
    margin = bA.raw_score(X).astype(np.float64)
    dfc = DataFrame({"features": X, "label": y, "margin": margin})
    _zero_launch_counts()
    t0 = time.perf_counter()
    C = LightGBMClassifier(init_score_col="margin", **params).fit(dfc)
    secs["init_score_c"] = time.perf_counter() - t0
    _k6_19("init_score_c", iters, launches)
    bC = C.booster
    if bC.base_score != 0.0 or bC.num_trees != iters:
        raise AssertionError(f"19a C: base_score {bC.base_score}, "
                             f"{bC.num_trees} trees")
    c_ties = _tree_ties("19a C's first tree against B's 51st",
                        (bC.feats[0], bC.thr_raw[0], bC.gains[0]),
                        (bB.feats[iters], bB.thr_raw[iters],
                         bB.gains[iters]))
    c_agree = sum(bool(np.array_equal(bC.feats[t], bB.feats[iters + t])
                       and np.array_equal(bC.thr_raw[t],
                                          bB.thr_raw[iters + t]))
                  for t in range(iters))
    del dfc, margin, C
    # 4. SHAP through features_shap_col
    n_shap = cfg["shap_rows"]
    B.set(features_shap_col="shap")
    t0 = time.perf_counter()
    out = B.transform(DataFrame({"features": X[:n_shap]}))
    torch.cuda.synchronize()
    secs["shap_transform"] = time.perf_counter() - t0
    phi = np.stack(list(out["shap"]))
    raw = np.stack(list(out["rawPrediction"]))[:, 1]
    if phi.shape != (n_shap, X.shape[1] + 1) or phi.dtype != np.float32:
        raise AssertionError(f"19a SHAP: {phi.shape} {phi.dtype}")
    shap_gap = _shap_additive("19a SHAP", phi, raw)
    k = cfg["shap_cpu_rows"]
    t0 = time.perf_counter()
    phi_cpu = Booster.from_string(bB.to_string(), device="cpu") \
        .shap_values(X[:k])
    secs["shap_cpu_1024"] = time.perf_counter() - t0
    shap_err = float(np.abs(phi[:k].astype(np.float64) - phi_cpu).max())
    if shap_err > 1e-6 * float(np.abs(phi_cpu).max()):
        raise AssertionError(f"19a SHAP: card vs CPU {shap_err}")
    shap_launches, secs["shap_profiled"] = _shap_launches(bB, X[:n_shap])
    B.set(features_shap_col=None)
    # 5. ONNX: the exported graph through ONNXModel
    n_onnx = cfg["onnx_rows"]
    oo, onnx_rps, h2d, secs["onnx_transform"] = _onnx_rows(
        B.to_onnx(), X[:n_onnx], {"p": "probabilities", "label": "label"},
        cfg["onnx_batch"])
    t0 = time.perf_counter()
    bt = B.transform(DataFrame({"features": X[:n_onnx]}))
    secs["model_transform"] = time.perf_counter() - t0
    want = np.stack(list(bt["probability"]))
    got = np.stack(list(oo["p"]))
    onnx_err = float(np.abs(got.astype(np.float64) - want).max())
    if got.shape != want.shape or onnx_err > 1e-5:
        raise AssertionError(f"19a ONNX: probabilities off by {onnx_err}")
    labels = np.asarray(oo["label"])
    sure = np.abs(want[:, 1] - 0.5) > 1e-5
    if labels.dtype != np.int64 or not np.array_equal(
            labels[sure], (want[sure, 1] > 0.5).astype(np.int64)):
        raise AssertionError(f"19a ONNX: labels ({labels.dtype}) differ")
    want_h2d = _padded_feature_bytes(n_onnx, cfg["onnx_batch"], X.shape[1])
    if h2d != want_h2d:
        raise AssertionError(f"19a ONNX: {h2d} h2d bytes, the features "
                             f"{want_h2d}")
    del oo, bt, got, want
    # 6. refit on new rows
    lo, hi = cfg["refit_rows"]
    t0 = time.perf_counter()
    R = bB.refit(X[lo:hi], y[lo:hi])
    torch.cuda.synchronize()
    secs["refit"] = time.perf_counter() - t0
    _same_arrays("19a refit structures", R, bB,
                 ("feats", "thr_raw", "gains", "covers"))
    kc = cfg["refit_cpu_rows"]
    r_card = bB.refit(X[lo:lo + kc], y[lo:lo + kc])
    r_cpu = Booster.from_string(bB.to_string(), device="cpu").refit(
        X[lo:lo + kc], y[lo:lo + kc])
    refit_err = float(np.abs(r_card.leaf_values.astype(np.float64)
                             - r_cpu.leaf_values).max())
    if refit_err > 1e-5 * float(np.abs(r_cpu.leaf_values).max()):
        raise AssertionError(f"19a refit: card vs CPU {refit_err}")
    # 7. trees_to_dataframe
    tdf = bB.trees_to_dataframe()
    node_type = np.asarray(tdf["node_type"])
    split = node_type != "leaf"
    if len(tdf) != bB.num_trees * (31 + 32) or not (
            np.array_equal(np.asarray(tdf["split_feature"])[split],
                           bB.feats.ravel())
            and np.array_equal(np.asarray(tdf["threshold"])[split
                                                           & (node_type
                                                              == "split")],
                               bB.thr_raw.ravel()[bB.feats.ravel() >= 0]
                               .astype(np.float64))
            and np.array_equal(np.asarray(tdf["value"])[~split],
                               bB.leaf_values.ravel().astype(np.float64))):
        raise AssertionError("19a trees_to_dataframe differs from B's "
                             "arrays")
    rec = {"rows": len(y), "iterations": iters, "seconds": secs,
           "k6_launches": launches, "auc_a": auc_a, "auc_b": auc_b,
           "b_first_new_tree_ties": first_ties,
           "b_first_new_tree_equals_kernel_rebuild": first_equals_b,
           "c_first_tree_ties_with_b51": c_ties,
           "c_trees_agreeing_with_b_new": c_agree,
           "shap": {"rows": n_shap, "rows_per_s": n_shap
                    / secs["shap_transform"],
                    "launches": shap_launches,
                    "launches_per_tree": shap_launches / bB.num_trees,
                    "additivity_worst_of_bound": shap_gap,
                    "card_vs_cpu_max_abs": shap_err},
           "onnx": {"rows": n_onnx, "rows_per_s": onnx_rps,
                    "model_transform_rows_per_s": n_onnx
                    / secs["model_transform"],
                    "prob_max_abs_err": onnx_err, "h2d_bytes": h2d},
           "refit": {"rows": hi - lo, "card_vs_cpu_max_abs": refit_err},
           "trees_to_dataframe_rows": len(tdf)}
    log(f"[afterfit 19a] {json.dumps(rec)} | {dev_info['smi']}")
    del X, y, df
    torch.cuda.empty_cache()
    return rec


def phase_afterfit_more(dev_info):
    """19b: a 7-class model at 12b's Covertype shape (SHAP, SOFTMAX export,
    an (n, 7) init_score fit) and a regressor on 1M HIGGS rows (its
    TreeEnsembleRegressor through ``ONNXModel``)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.gbdt import (LightGBMClassifier,
                                                LightGBMRegressor)
    cfg = AFTERFIT
    launches, secs = {}, {}
    n, F, K = COVTYPE["rows"], COVTYPE["features"], COVTYPE["classes"]
    X, y = make_covtype_like(n, F, K)
    df = DataFrame({"features": X, "label": y})
    params = dict(objective="multiclass", num_leaves=31, max_bin=255,
                  learning_rate=0.1)
    _zero_launch_counts()
    t0 = time.perf_counter()
    M = LightGBMClassifier(num_iterations=cfg["multi_iters"],
                           **params).fit(df)
    secs["fit_multiclass"] = time.perf_counter() - t0
    _k6_19("multiclass", cfg["multi_iters"], launches)
    bM = M.booster
    ns = cfg["multi_shap_rows"]
    t0 = time.perf_counter()
    phi = bM.shap_values(X[:ns])
    secs["shap_multiclass"] = time.perf_counter() - t0
    raw = bM.raw_score(X[:ns])
    if phi.shape != (K, ns, F + 1):
        raise AssertionError(f"19b SHAP: {phi.shape}")
    gap = max(_shap_additive(f"19b SHAP class {k}", phi[k], raw[:, k])
              for k in range(K))
    m_launches = _shap_launches(bM, X[:ns])[0]
    no = cfg["multi_onnx_rows"]
    oo, m_rps, _, _ = _onnx_rows(M.to_onnx(), X[:no],
                                 {"p": "probabilities"}, cfg["onnx_batch"])
    got = np.stack(list(oo["p"]))
    want = bM.predict(X[:no])
    m_err = float(np.abs(got.astype(np.float64) - want).max())
    m_sum = float(np.abs(got.astype(np.float64).sum(axis=1) - 1).max())
    if m_err > 1e-5 or m_sum > 1e-6:
        raise AssertionError(f"19b ONNX: probabilities off by {m_err}, "
                             f"row sums by {m_sum}")
    dfi = DataFrame({"features": X, "label": y,
                     "margin": bM.raw_score(X).astype(np.float64)})
    _zero_launch_counts()
    t0 = time.perf_counter()
    I = LightGBMClassifier(num_iterations=cfg["multi_init_iters"],
                           init_score_col="margin", **params).fit(dfi)
    secs["fit_multiclass_init_score"] = time.perf_counter() - t0
    _k6_19("multiclass_init_score", cfg["multi_init_iters"], launches)
    if I.booster.num_trees != K * cfg["multi_init_iters"]:
        raise AssertionError(f"19b init_score: {I.booster.num_trees} trees")
    del X, y, df, dfi, oo
    torch.cuda.empty_cache()
    # the regressor on the first 1M HIGGS rows
    Xh, yh = make_higgs_like(cfg["reg_rows"], GBDT["features"])
    _zero_launch_counts()
    t0 = time.perf_counter()
    Rg = LightGBMRegressor(num_iterations=cfg["reg_iters"], num_leaves=31,
                           max_bin=255).fit(DataFrame({"features": Xh,
                                                       "label": yh}))
    secs["fit_regressor"] = time.perf_counter() - t0
    _k6_19("regressor", cfg["reg_iters"], launches)
    oo, r_rps, _, _ = _onnx_rows(Rg.to_onnx(), Xh, {"v": "variable"},
                                 cfg["onnx_batch"])
    got = np.stack(list(oo["v"])).astype(np.float64).reshape(len(Xh), -1)[:, 0]
    want = np.asarray(Rg.transform(DataFrame({"features": Xh}))
                      ["prediction"], dtype=np.float64)
    r_gap = float((np.abs(got - want) / (1e-5 * (1 + np.abs(want)))).max())
    if r_gap > 1.0:
        raise AssertionError(f"19b regressor ONNX: {r_gap} of the bound")
    rec = {"multiclass": {"rows": n, "classes": K,
                          "iterations": cfg["multi_iters"],
                          "shap_rows": ns,
                          "shap_rows_per_s": ns / secs["shap_multiclass"],
                          "shap_launches": m_launches,
                          "shap_additivity_worst_of_bound": gap,
                          "onnx_rows_per_s": m_rps,
                          "onnx_prob_max_abs_err": m_err,
                          "onnx_row_sum_max_err": m_sum},
           "regressor": {"rows": len(Xh), "iterations": cfg["reg_iters"],
                         "onnx_rows_per_s": r_rps,
                         "onnx_worst_of_bound": r_gap},
           "seconds": secs, "k6_launches": launches}
    log(f"[afterfit 19b] {json.dumps(rec)} | {dev_info['smi']}")
    del Xh, yh, oo
    torch.cuda.empty_cache()
    return rec


# ---- phase 20: full-sequence generation -------------------------------------

#: 20a: the target trains on ``markov_sampler`` batches over the first
#: ``lang_vocab`` ids of its 8192 (a language whose every transition a few
#: dozen steps see), then the draft distils from it on the same batches;
#: 20b-20d: B prompts of P tokens from the same language, ``new`` tokens
GEN20 = dict(lang_vocab=256, batch=32, seq=128, train_steps=60,
             distill_steps=60, lr_target=1e-3, lr_draft=2e-3, B=4, P=16,
             new=64, gamma=4, page_size=16, beam_new=16, beam_width=4,
             sample_new=32, temperature=0.8, top_k=50)
#: 20e: the GPT-style GreedySearch / BeamSearch decoder at the target's
#: widths with two layers; B rows of P tokens, ``new`` tokens
ORT_GEN = dict(layers=2, B=4, P=8, new=24, beam_new=12, beams=4,
               max_pos=64)
#: 20f: rows and sequence length of the BERT-base external-data check
EXT_BERT = dict(rows=32, seq=128, batch=16, seed=20)


def gpt_decoder_graph(V, D, H, layers, max_pos, seed=0):
    """The GPT-style decoder subgraph of the JAX package's generation tests
    (``tests/test_onnx_generation.py``'s ``_decoder_graph``) with ``layers``
    attention layers, each with its residual, its fused QKV and its own
    ``past_i`` / ``present_i`` (2, B, H, T, D / H): token + position
    embeddings, causal and padding masks from the shapes, an untied
    unembedding. Weights from ``seed``, scaled by 1 / sqrt(fan-in)."""
    import numpy as np
    from mmlspark_tpu_torch.onnx.builder import (make_graph, make_node,
                                                 make_tensor_value_info as vi)
    rng = np.random.default_rng(seed)
    hd = D // H

    def w(*shape):
        return rng.normal(0, 1 / np.sqrt(shape[0]), shape).astype(np.float32)

    init = {"tok_table": rng.normal(0, 0.7, (V, D)).astype(np.float32),
            "pos_table": rng.normal(0, 0.3, (max_pos, D)).astype(np.float32),
            "unembed": w(D, V),
            "scale": np.array(1.0 / np.sqrt(hd), np.float32),
            "one_f": np.array([1.0], np.float32),
            "big_neg": np.array(-1e9, np.float32),
            "i1": np.array(1, np.int64), "i0_idx": np.array(0, np.int64),
            "i1_idx": np.array(1, np.int64),
            "perm_shape": np.array([0, 0, H, hd], np.int64),
            "merge_shape": np.array([0, 0, D], np.int64)}
    n = make_node
    nodes = [n("Gather", ["tok_table", "input_ids"], ["te"]),
             n("Gather", ["pos_table", "position_ids"], ["pe"]),
             n("Add", ["te", "pe"], ["h0"]),
             n("Shape", ["input_ids"], ["ids_shape"]),
             n("Gather", ["ids_shape", "i1"], ["S_"], axis=0),
             n("Shape", ["attention_mask"], ["m_shape"]),
             n("Gather", ["m_shape", "i1"], ["T_"], axis=0),
             n("Sub", ["T_", "S_"], ["Ppast"]),
             n("Unsqueeze", ["S_"], ["S_u"], axes=[0]),
             n("Unsqueeze", ["T_"], ["T_u"], axes=[0]),
             n("Concat", ["S_u", "T_u"], ["st"], axis=0),
             n("Expand", ["one_f", "st"], ["ones_st"]),
             n("Trilu", ["ones_st", "Ppast"], ["tril"], upper=0),
             n("Sub", ["tril", "one_f"], ["tril0"]),
             n("Mul", ["tril0", "big_neg"], ["causal_neg"]),
             n("Sub", ["one_f", "attention_mask"], ["padm"]),
             n("Mul", ["padm", "big_neg"], ["pad_neg"]),
             n("Unsqueeze", ["pad_neg"], ["pad_neg4"], axes=[1, 2])]
    for i in range(layers):
        init[f"w_qkv{i}"] = w(D, 3 * D)
        init[f"w_out{i}"] = w(D, D)
        h, t = f"h{i}", f"_{i}"
        nodes += [
            n("MatMul", [h, f"w_qkv{i}"], ["qkv" + t]),
            n("Split", ["qkv" + t], ["q0" + t, "k0" + t, "v0" + t], axis=-1,
              num_outputs=3),
            n("Reshape", ["q0" + t, "perm_shape"], ["q1" + t]),
            n("Reshape", ["k0" + t, "perm_shape"], ["k1" + t]),
            n("Reshape", ["v0" + t, "perm_shape"], ["v1" + t]),
            n("Transpose", ["q1" + t], ["q" + t], perm=[0, 2, 1, 3]),
            n("Transpose", ["k1" + t], ["kn" + t], perm=[0, 2, 1, 3]),
            n("Transpose", ["v1" + t], ["vn" + t], perm=[0, 2, 1, 3]),
            n("Gather", [f"past_{i}", "i0_idx"], ["kp" + t], axis=0),
            n("Gather", [f"past_{i}", "i1_idx"], ["vp" + t], axis=0),
            n("Concat", ["kp" + t, "kn" + t], ["K" + t], axis=2),
            n("Concat", ["vp" + t, "vn" + t], ["Vv" + t], axis=2),
            n("Transpose", ["K" + t], ["Kt" + t], perm=[0, 1, 3, 2]),
            n("MatMul", ["q" + t, "Kt" + t], ["s0" + t]),
            n("Mul", ["s0" + t, "scale"], ["s1" + t]),
            n("Add", ["s1" + t, "causal_neg"], ["s2" + t]),
            n("Add", ["s2" + t, "pad_neg4"], ["s3" + t]),
            n("Softmax", ["s3" + t], ["p" + t], axis=-1),
            n("MatMul", ["p" + t, "Vv" + t], ["ctx" + t]),
            n("Transpose", ["ctx" + t], ["ctx1" + t], perm=[0, 2, 1, 3]),
            n("Reshape", ["ctx1" + t, "merge_shape"], ["ctx2" + t]),
            n("MatMul", ["ctx2" + t, f"w_out{i}"], ["ho" + t]),
            n("Add", [h, "ho" + t], [f"h{i + 1}"]),
            n("Unsqueeze", ["K" + t], ["K5" + t], axes=[0]),
            n("Unsqueeze", ["Vv" + t], ["V5" + t], axes=[0]),
            n("Concat", ["K5" + t, "V5" + t], [f"present_{i}"], axis=0)]
    nodes.append(n("MatMul", [f"h{layers}", "unembed"], ["logits"]))
    return make_graph(
        nodes, "gpt_step",
        inputs=[vi("input_ids", np.int32, ["B", "S"]),
                vi("position_ids", np.int32, ["B", "S"]),
                vi("attention_mask", np.float32, ["B", "T"])]
        + [vi(f"past_{i}", np.float32, [2, "B", H, "P", hd])
           for i in range(layers)],
        outputs=[vi("logits", np.float32, ["B", "S", V])]
        + [vi(f"present_{i}", np.float32, [2, "B", H, "T", hd])
           for i in range(layers)],
        initializers=init)


def ort_generation_onnx(op, decoder, max_length, eos, num_beams=4,
                        num_return=1, length_penalty=1.0):
    """A ``GreedySearch`` or ``BeamSearch`` graph (com.microsoft,
    ``model_type`` 0) over ``decoder``: input ``input_ids`` (B, P) int32,
    output ``sequences`` (and ``sequences_scores`` for the beam), the
    shape-like inputs as initializers, pad id 0."""
    import numpy as np
    from mmlspark_tpu_torch.onnx.builder import (make_graph, make_model,
                                                 make_node,
                                                 make_tensor_value_info as vi)
    inits = {"max_length": np.array(max_length, np.int64)}
    out_names = ["sequences"]
    if op == "GreedySearch":
        names, outs = ["input_ids", "max_length"], [
            vi("sequences", np.int32, ["B", "L"])]
    else:
        out_names.append("sequences_scores")
        names = ["input_ids", "max_length", "", "num_beams",
                 "num_return_sequences", "length_penalty"]
        inits.update(num_beams=np.array(num_beams, np.int64),
                     num_return_sequences=np.array(num_return, np.int64),
                     length_penalty=np.array(length_penalty, np.float32))
        outs = [vi("sequences", np.int32, ["B", "R", "L"]),
                vi("sequences_scores", np.float32, ["B", "R"])]
    node = make_node(op, names, out_names,
                     domain="com.microsoft", decoder=decoder,
                     eos_token_id=eos, pad_token_id=0, model_type=0)
    g = make_graph([node], "gen",
                   inputs=[vi("input_ids", np.int32, ["B", "P"])],
                   outputs=outs, initializers=inits)
    return make_model(g, extra_opsets={"com.microsoft": 1})


def extra_op_cases():
    """One-node graphs of the 22 handlers of the reference's
    ``onnx/extra_ops.py`` whose output is a function of their inputs (the
    four ``Random*`` draw from the device's own generator: 20g holds them
    apart), at the shapes ``tests/test_torch_onnx_extra_ops.py`` uses or
    larger. {name: (model bytes, feeds, exact)}; integer outputs bitwise."""
    import numpy as np
    from mmlspark_tpu_torch.onnx.builder import (make_graph, make_model,
                                                 make_node,
                                                 make_tensor_value_info as vi)
    g = np.random.default_rng(20)

    def r(*shape, s=1.0):
        return g.normal(0, s, shape).astype(np.float32)

    def one(op, feeds, inits=None, ins=None, outs=("y",), **attrs):
        gr = make_graph([make_node(op, list(ins or feeds), list(outs),
                                   **attrs)], "t",
                        [vi(k, v.dtype, list(v.shape))
                         for k, v in feeds.items()],
                        [vi(o, np.float32, []) for o in outs],
                        initializers=inits or {})
        return (make_model(gr, opset=18,
                           extra_opsets={"com.microsoft": 1}), feeds, False)

    i32 = g.integers(-2 ** 20, 2 ** 20, (2, 64)).astype(np.int32)
    j32 = g.integers(-2 ** 20, 2 ** 20, (2, 64)).astype(np.int32)
    cases = {op: one(op, {"a": i32, "b": j32}) for op in
             ("BitwiseAnd", "BitwiseOr", "BitwiseXor")}
    cases["BitwiseNot"] = one("BitwiseNot", {"a": i32})
    x4 = r(4, 16, 12, 12)
    cases["LRN"] = one("LRN", {"x": x4}, size=5, alpha=1e-3, beta=0.75,
                       bias=2.0)
    cases["MeanVarianceNormalization"] = one("MeanVarianceNormalization",
                                             {"x": x4})
    cases["GlobalLpPool"] = one("GlobalLpPool", {"x": x4}, p=3)
    cases["LpPool"] = one("LpPool", {"x": x4}, kernel_shape=[3, 3],
                          strides=[2, 2], pads=[1, 1, 1, 1], p=2)
    pooled = r(2, 3, 4, 4)
    flat_idx = np.stack([np.stack([
        (np.arange(16).reshape(4, 4) // 4 * 2 * 8 + np.arange(16).reshape(
            4, 4) % 4 * 2 + (b + c) % 2) + (b * 3 + c) * 64
        for c in range(3)]) for b in range(2)]).astype(np.int64)
    cases["MaxUnpool"] = one("MaxUnpool", {"x": pooled, "i": flat_idx},
                             kernel_shape=[2, 2], strides=[2, 2])
    a8 = g.integers(0, 256, (4, 32, 256)).astype(np.uint8)
    b8 = g.integers(-128, 128, (256, 64)).astype(np.int8)
    cases["MatMulInteger"] = one(
        "MatMulInteger", {"a": a8}, {"b": b8,
                                     "azp": np.uint8(131).reshape(()),
                                     "bzp": g.integers(-4, 4, 64).astype(
                                         np.int8)},
        ins=["a", "b", "azp", "bzp"])
    xc = g.integers(0, 256, (2, 8, 20, 20)).astype(np.uint8)
    wc = g.integers(-128, 128, (16, 8, 3, 3)).astype(np.int8)
    cases["ConvInteger"] = one(
        "ConvInteger", {"x": xc}, {"w": wc, "xzp": np.uint8(7).reshape(()),
                                   "wzp": np.int8(-2).reshape(())},
        ins=["x", "w", "xzp", "wzp"], pads=[1, 1, 1, 1], strides=[1, 2])
    cases["DynamicQuantizeLinear"] = one(
        "DynamicQuantizeLinear", {"x": r(64, 33, s=3.0)},
        outs=("y", "s", "z"))
    T, Bt, I, H = 64, 8, 16, 32
    cases["RNN"] = one(
        "RNN", {"x": r(T, Bt, I)},
        {"w": r(2, H, I, s=0.3), "r": r(2, H, H, s=0.2),
         "b": r(2, 2 * H, s=0.1), "h0": r(2, Bt, H)},
        ins=["x", "w", "r", "b", "", "h0"], outs=("Y", "Yh"),
        hidden_size=H, direction="bidirectional")
    logp = np.log(g.dirichlet(np.ones(10), size=(32,))).astype(np.float32)
    tgt = g.integers(0, 10, 32).astype(np.int64)
    cases["NegativeLogLikelihoodLoss"] = one(
        "NegativeLogLikelihoodLoss", {"x": logp, "t": tgt},
        {"w": g.random(10).astype(np.float32)}, ins=["x", "t", "w"],
        reduction="mean", ignore_index=3)
    cases["SoftmaxCrossEntropyLoss"] = one(
        "SoftmaxCrossEntropyLoss",
        {"x": r(16, 10, 6, s=2.0), "t": g.integers(0, 10, (16, 6)).astype(
            np.int64)}, outs=("y", "lp"), reduction="sum")
    cases["Det"] = one("Det", {"x": r(64, 4, 4)})
    for op in ("HannWindow", "HammingWindow", "BlackmanWindow"):
        cases[op] = one(op, {"x": np.zeros(1, np.float32)},
                        {"n": np.array(400, np.int64)}, ins=["n"],
                        periodic=int(op != "BlackmanWindow"))
    sig = r(4, 1024, 1)
    cases["DFT"] = one("DFT", {"x": sig}, onesided=1)
    cases["STFT"] = one("STFT", {"x": sig}, {"step": np.array(160, np.int64),
                                             "w": np.hanning(400).astype(
                                                 np.float32)},
                        ins=["x", "step", "w"], onesided=1)
    cases["MelWeightMatrix"] = one(
        "MelWeightMatrix", {"x": np.zeros(1, np.float32)},
        {"nm": np.array(80, np.int64), "dft": np.array(400, np.int64),
         "sr": np.array(16000, np.int64), "lo": np.array(0.0, np.float32),
         "hi": np.array(8000.0, np.float32)},
        ins=["nm", "dft", "sr", "lo", "hi"])
    return cases


def _random_ops_on_card(dev_info):
    """20g's ``Random*`` ops on the card: the port's own generator, so held
    by their law, not by the CPU's draws: the same graph twice gives the
    same values; 2^20 normal draws (mean 1, scale 2) and uniform draws on
    [2, 3) within 6 standard errors of their mean and spread, every
    uniform inside its range."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.onnx import (convert_model, make_graph,
                                         make_model, make_node,
                                         make_tensor_value_info as vi)
    n = 1 << 20
    x = np.zeros((n,), np.float32)
    nodes = [make_node("RandomNormal", [], ["a"], shape=[n], mean=1.0,
                       scale=2.0, seed=7.0),
             make_node("RandomUniformLike", ["x"], ["b"], low=2.0, high=3.0),
             make_node("RandomNormalLike", ["x"], ["c"]),
             make_node("RandomUniform", [], ["d"], shape=[n], seed=3.0)]
    cm = convert_model(make_model(make_graph(
        nodes, "rnd", [vi("x", np.float32, [n])],
        [vi(o, np.float32, [n]) for o in "abcd"])))
    dev = torch.device("cuda")
    feeds = {"x": torch.from_numpy(x).to(dev)}
    one, two = cm({}, feeds), cm({}, feeds)
    rec = {}
    for o, mean, std in (("a", 1.0, 2.0), ("b", 2.5, np.sqrt(1 / 12)),
                         ("c", 0.0, 1.0), ("d", 0.5, np.sqrt(1 / 12))):
        if not torch.equal(one[o], two[o]) or one[o].device.type != dev.type:
            raise AssertionError(f"20g Random {o}: not a fixed draw on the "
                                 f"card")
        v = one[o].double()
        m, s = float(v.mean()), float(v.std())
        se = std / np.sqrt(n)
        if abs(m - mean) > 6 * se or abs(s - std) > 6 * std / np.sqrt(2 * n):
            raise AssertionError(f"20g Random {o}: mean {m}, std {s} (want "
                                 f"{mean}, {std})")
        rec[o] = {"mean": m, "std": s}
    for o, lo, hi in (("b", 2.0, 3.0), ("d", 0.0, 1.0)):
        if not bool(((one[o] >= lo) & (one[o] < hi)).all()):
            raise AssertionError(f"20g Random {o}: outside [{lo}, {hi})")
    log(f"[random ops 20g] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _zero_gen_counts():
    """K1/K2 and K7/K8a/K8b launch counters and flash plain calls to 0."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain)
    _zero_pa_counts()
    flash_attention.launches = flash_attention.launches_dkv = 0
    flash_attention.launches_dq = 0
    flash_attention_plain.calls = flash_attention_bwd_plain.calls = 0


def _flash_counts():
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain)
    return (flash_attention.launches, flash_attention.launches_dkv,
            flash_attention.launches_dq,
            flash_attention_plain.calls + flash_attention_bwd_plain.calls)


def phase_gen_training(dev_info):
    """20a: ``distill.train_lm`` on bench.py's generation target (bf16,
    ``use_flash``), then ``distill_draft`` of its draft from it, both on
    ``markov_sampler`` batches: the LM loss falls and the KL falls below
    half its start (the reference test's checks), every step's
    attention on K7 forward and K8a / K8b backward (target: 8 of each a
    step; distillation: the frozen teacher's 8 K7 and the draft's 2 of
    each), no plain call; seconds a step."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.zoo import distill
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    cfg, d_cfg = _spec_cfgs(torch.bfloat16)
    cfg, d_cfg = cfg._replace(use_flash=True), d_cfg._replace(use_flash=True)
    G = GEN20
    batch_fn = distill.markov_sampler(G["lang_vocab"], G["batch"], G["seq"],
                                      seed=3)
    t0_np = init_transformer(cfg, seed=0)
    rec = {}
    # two untimed steps of each loop first: library loads, cuBLAS handles
    distill.train_lm(t0_np, cfg, batch_fn, 2)
    distill.distill_draft(t0_np, cfg, d_cfg, batch_fn, 2, seed=1)
    _zero_gen_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_np, hist = distill.train_lm(t0_np, cfg, batch_fn, G["train_steps"],
                                  learning_rate=G["lr_target"], log_every=1)
    t_s = time.perf_counter() - t0
    k7, k8a, k8b, plain = _flash_counts()
    want = (G["train_steps"] * cfg.layers,) * 3
    if (k7, k8a, k8b) != want or plain:
        raise AssertionError(f"20a train_lm: K7/K8a/K8b {(k7, k8a, k8b)} "
                             f"(want {want}), plain calls {plain}")
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        raise AssertionError(f"20a train_lm: losses {hist}")
    rec["train_lm"] = {
        "steps": G["train_steps"], "batch": G["batch"], "seq": G["seq"],
        "lr": G["lr_target"], "loss_first": hist[0], "loss_last": hist[-1],
        "losses": hist, "seconds": t_s, "s_per_step": t_s / len(hist),
        "k7_launches": k7, "k8a_launches": k8a, "k8b_launches": k8b}
    _zero_gen_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_np, d_hist = distill.distill_draft(
        t_np, cfg, d_cfg, batch_fn, G["distill_steps"],
        learning_rate=G["lr_draft"], seed=1)
    d_s = time.perf_counter() - t0
    k7d, k8ad, k8bd, plain = _flash_counts()
    n = G["distill_steps"]
    want = (n * (cfg.layers + d_cfg.layers), n * d_cfg.layers,
            n * d_cfg.layers)
    if (k7d, k8ad, k8bd) != want or plain:
        raise AssertionError(f"20a distill_draft: K7/K8a/K8b "
                             f"{(k7d, k8ad, k8bd)} (want {want}), plain "
                             f"calls {plain}")
    if not (np.isfinite(d_hist).all() and d_hist[-1] < 0.5 * d_hist[0]):
        raise AssertionError(f"20a distill_draft: KL {d_hist}")
    rec["distill_draft"] = {
        "steps": n, "lr": G["lr_draft"], "kl_first": d_hist[0],
        "kl_last": d_hist[-1], "kl": d_hist, "seconds": d_s,
        "s_per_step": d_s / n, "k7_launches": k7d, "k8a_launches": k8ad,
        "k8b_launches": k8bd}
    rec["k7_launches"] = k7 + k7d
    rec["k8a_launches"] = k8a + k8ad
    rec["k8b_launches"] = k8b + k8bd
    log(f"[gen training 20a] {json.dumps(rec)} | {dev_info['smi']}")
    return rec, t_np, d_np, batch_fn


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_gen_speculative(dev_info, t_np, d_np, batch_fn):
    """20b: the trained target with the distilled draft and with a random
    one (seed 1), f32 and bf16, gamma 4, 4 prompts of the training
    language: ``generate_speculative_paged(paged_attn="kernel")`` (K1 on
    every verify window, W = 5: the FMA body in f32, the tensor-core body
    in bf16, rounds x 8 launches, nothing else), ``generate_speculative``
    and ``generate_cached``. f32: both speculative loops' ids equal
    ``generate_cached``'s; bf16: the share of tokens that agree. Each run
    once untimed, then timed: tokens/s, acceptance, target forwards per
    emitted token."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.zoo import speculative as spec
    from mmlspark_tpu_torch.models.zoo import transformer as tf
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    G = GEN20
    dev = torch.device("cuda")
    prompts = batch_fn(10_000)[:G["B"], :G["P"]]
    rec = {"B": G["B"], "P": G["P"], "new": G["new"], "gamma": G["gamma"]}
    launches = {"fma": 0, "mma": 0}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        cfg, d_cfg = _spec_cfgs(dtype)
        tp = tf.params_from_numpy(t_np, cfg, dev)
        drafts = {"distilled": tf.params_from_numpy(d_np, d_cfg, dev),
                  "random": tf.params_from_numpy(
                      tf.init_transformer(d_cfg, seed=1), d_cfg, dev)}
        kw = dict(max_new_tokens=G["new"])
        tf.generate_cached(tp, prompts, cfg, **kw)
        ref_ids, secs = _timed(lambda: tf.generate_cached(tp, prompts, cfg,
                                                          **kw))
        ref_ids = ref_ids.cpu().numpy()
        out = {"generate_cached": {"tokens_per_s": G["B"] * G["new"] / secs,
                                   "seconds": secs}}
        for dname, dp in drafts.items():
            for fn_name in ("generate_speculative_paged",
                            "generate_speculative"):
                fn = getattr(spec, fn_name)
                extra = (dict(page_size=G["page_size"], paged_attn="kernel")
                         if fn_name.endswith("paged") else {})
                fn(tp, dp, prompts, cfg, d_cfg, gamma=G["gamma"], **kw,
                   **extra)
                _zero_gen_counts()
                (ids, stats), secs = _timed(lambda: fn(
                    tp, dp, prompts, cfg, d_cfg, gamma=G["gamma"], **kw,
                    **extra))
                ids = ids.cpu().numpy()
                same = float((ids[:, G["P"]:] == ref_ids[:, G["P"]:]).mean())
                r = {"tokens_per_s": G["B"] * G["new"] / secs,
                     "seconds": secs, "rounds": stats["rounds"],
                     "accepted_drafts": stats["accepted_drafts"],
                     "accepted_per_round": (stats["accepted_drafts"]
                                            / max(stats["rounds"], 1)),
                     "target_forwards": stats["target_forwards"],
                     "target_forwards_per_token": (stats["target_forwards"]
                                                   / G["new"]),
                     "agree_with_generate_cached": same}
                k1 = paged_attention_window.launches
                if fn_name.endswith("paged"):
                    b = _bodies()
                    want = stats["rounds"] * cfg.layers
                    body = "mma" if name == "bf16" else "fma"
                    fma = k1 - b["mma"] - b["split"]
                    got = b["mma"] if body == "mma" else fma
                    if (k1 != want or got != want
                            or paged_attention_window.launches_q):
                        raise AssertionError(
                            f"20b {name} {dname}: K1 {k1} launches ({b}), "
                            f"want {want} verify windows x layers on the "
                            f"{body} body")
                    r.update(paged_attn_impl=stats["paged_attn_impl"],
                             k1_launches=k1, k1_body=body)
                    launches[body] += k1
                elif k1:
                    raise AssertionError(f"20b {fn_name}: {k1} K1 launches")
                if name == "f32" and same != 1.0:
                    raise AssertionError(
                        f"20b f32 {dname} {fn_name}: ids differ from "
                        f"generate_cached's ({same:.4f} agree)")
                out[f"{fn_name} {dname}"] = r
        rec[name] = out
        del tp, drafts
        torch.cuda.empty_cache()
    rec["k1_launches_fma"] = launches["fma"]
    rec["k1_launches_mma"] = launches["mma"]
    log(f"[gen speculative 20b] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_gen_beam_sampling(dev_info, t_np, batch_fn):
    """20c: ``generate_beam`` (W = 4) of the trained f32 target without and
    with eos (the 3rd token of row 0's best hypothesis without it): ids
    equal the port's CPU run of the same call, scores within 1e-5 x
    max|score| of it. 20d: sampled ``generate`` (``use_flash``: K7 each
    step, new x 8 launches) and ``generate_cached`` (temperature 0.8,
    top-k 50, one seed) give the same tokens on the card; tokens/s of
    each."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.zoo import transformer as tf
    G = GEN20
    dev = torch.device("cuda")
    cfg, _ = _spec_cfgs(torch.float32)
    prompts = batch_fn(10_001)[:2, :G["P"]]
    tp = tf.params_from_numpy(t_np, cfg, dev)
    tc = tf.params_from_numpy(t_np, cfg, "cpu")
    beam = {"W": G["beam_width"], "new": G["beam_new"], "B": 2}
    eos = None
    for label in ("no_eos", "eos"):
        eos_id = None if label == "no_eos" else eos
        kw = dict(max_new_tokens=G["beam_new"], num_beams=G["beam_width"],
                  eos_id=eos_id)
        (ids, scores), secs = _timed(lambda: tf.generate_beam(
            tp, prompts, cfg, **kw))
        c_ids, c_scores = tf.generate_beam(tc, prompts, cfg, **kw)
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        err = float(np.abs(scores - c_scores.numpy()).max())
        tol = 1e-5 * float(np.abs(c_scores.numpy()).max())
        if not np.array_equal(ids, c_ids.numpy()) or err > tol:
            raise AssertionError(f"20c beam {label}: ids equal "
                                 f"{np.array_equal(ids, c_ids.numpy())}, "
                                 f"score error {err} (bound {tol})")
        beam[label] = {"seconds": secs, "max_abs_err_scores": err,
                       "scores": scores.tolist(),
                       "eos_fired": bool(eos_id is not None
                                         and (ids[:, G["P"]:] == eos).any())}
        if eos is None:
            # eos: the 3rd token of row 0's best hypothesis without one
            eos = beam["eos"] = int(ids[0, G["P"] + 2])
    del tc
    fcfg = cfg._replace(use_flash=True)
    prompts4 = batch_fn(10_002)[:G["B"], :G["P"]]
    kw = dict(max_new_tokens=G["sample_new"], temperature=G["temperature"],
              top_k=G["top_k"], seed=20)
    tf.generate(tp, prompts4, fcfg, **dict(kw, max_new_tokens=2))
    _zero_gen_counts()
    a, secs_a = _timed(lambda: tf.generate(tp, prompts4, fcfg, **kw))
    k7, _, _, plain = _flash_counts()
    if k7 != G["sample_new"] * cfg.layers or plain:
        raise AssertionError(f"20d generate(use_flash): {k7} K7 launches "
                             f"(want {G['sample_new'] * cfg.layers}), plain "
                             f"calls {plain}")
    b, secs_b = _timed(lambda: tf.generate_cached(tp, prompts4, cfg, **kw))
    if not torch.equal(a, b):
        raise AssertionError("20d: sampled generate and generate_cached "
                             "differ on the card")
    samp = {"B": G["B"], "new": G["sample_new"], "temperature":
            G["temperature"], "top_k": G["top_k"], "k7_launches": k7,
            "generate_tokens_per_s": G["B"] * G["sample_new"] / secs_a,
            "generate_cached_tokens_per_s": G["B"] * G["sample_new"] / secs_b,
            "distinct_rows": len({tuple(r) for r in a.cpu().tolist()})}
    del tp
    torch.cuda.empty_cache()
    log(f"[gen beam 20c] {json.dumps(beam)} | {dev_info['smi']}")
    log(f"[gen sampling 20d] {json.dumps(samp)} | {dev_info['smi']}")
    return beam, samp


def phase_gen_ort(dev_info):
    """20e: ORT ``GreedySearch`` and ``BeamSearch`` (W = 4) over a two-layer
    GPT-style decoder subgraph at the target's widths (vocab 8192, d 512,
    8 heads) through ``ONNXModel(compute_dtype="float32")`` on the card:
    sequences (and beam scores within 1e-5 x max|score|) equal the port's
    CPU run of the same model; seconds of each."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    from mmlspark_tpu_torch.serving.tick_profile import SPEC
    O = ORT_GEN
    dec = gpt_decoder_graph(SPEC["vocab"], SPEC["d_model"], SPEC["heads"],
                            O["layers"], O["max_pos"], seed=5)
    rng = np.random.default_rng(21)
    ids = rng.integers(1, SPEC["vocab"], (O["B"], O["P"])).astype(np.int32)
    eos = SPEC["vocab"] - 1
    rec = {}
    for op, new, fetch in (
            ("GreedySearch", O["new"], {"seq": "sequences"}),
            ("BeamSearch", O["beam_new"],
             {"seq": "sequences", "score": "sequences_scores"})):
        data = ort_generation_onnx(op, dec, O["P"] + new, eos,
                                   num_beams=O["beams"])
        kw = dict(feed_dict={"input_ids": "ids"}, fetch_dict=fetch,
                  mini_batch_size=O["B"], compute_dtype="float32")
        m = ONNXModel(data, **kw)
        m.transform(DataFrame({"ids": ids}))
        out, secs = _timed(lambda: m.transform(DataFrame({"ids": ids})))
        cpu = ONNXModel(data, device="cpu", **kw).transform(
            DataFrame({"ids": ids}))
        got, want = np.stack(out["seq"]), np.stack(cpu["seq"])
        r = {"seconds": secs, "new": new,
             "generated_distinct": int(len(np.unique(got[..., O["P"]:])))}
        if not np.array_equal(got, want):
            raise AssertionError(f"20e {op}: card sequences differ from the "
                                 f"CPU's")
        if "score" in fetch:
            s, cs = np.asarray(out["score"], np.float64), \
                np.asarray(cpu["score"], np.float64)
            err = float(np.abs(s - cs).max())
            if err > 1e-5 * float(np.abs(cs).max()):
                raise AssertionError(f"20e {op}: scores off the CPU's by "
                                     f"{err}")
            r["max_abs_err_scores"] = err
        rec[op] = r
        del m
    torch.cuda.empty_cache()
    log(f"[ort generation 20e] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_external_data(dev_info):
    """20f: BERT-base (phase 14's widths, ``export_bert_onnx``) written with
    its matrices in a sidecar file under ``build/phase20/`` and served
    through ``ONNXModel(external_data_dir=...)`` on the card: the hidden
    states of 32 rows bitwise those of the same export kept inline."""
    import shutil
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    from mmlspark_tpu_torch.models.zoo import bert_onnx as pbert
    E = EXT_BERT
    cfg = pbert.BertOnnxConfig(**{k: BERT_ONNX[k] for k in (
        "vocab", "layers", "d_model", "heads", "d_ff", "max_len")})
    params = pbert.init_bert_params(cfg, seed=E["seed"])
    ddir = os.path.join(HERE, "build", "phase20")
    shutil.rmtree(ddir, ignore_errors=True)
    ext = pbert.export_bert_onnx(cfg, params=params, external_data_dir=ddir)
    inline = pbert.export_bert_onnx(cfg, params=params)
    sidecar = os.path.getsize(os.path.join(ddir, "weights.bin"))
    ids, mask = bert_rows(E["rows"], E["seq"], cfg.vocab, E["seed"])
    kw = dict(feed_dict={"input_ids": "ids", "attention_mask": "mask"},
              fetch_dict={"hidden": "last_hidden_state"},
              mini_batch_size=E["batch"], compute_dtype="float32")
    df = DataFrame({"ids": ids, "mask": mask})
    got, secs = _timed(lambda: ONNXModel(ext, external_data_dir=ddir,
                                         **kw).transform(df))
    want = ONNXModel(inline, **kw).transform(df)
    if not np.array_equal(np.stack(got["hidden"]), np.stack(want["hidden"])):
        raise AssertionError("20f: the external-data graph's outputs are not "
                             "bitwise the inline graph's")
    rec = {"graph_bytes_external": len(ext), "graph_bytes_inline": len(inline),
           "sidecar_bytes": sidecar, "rows": E["rows"], "seq": E["seq"],
           "load_and_transform_s": secs}
    shutil.rmtree(ddir, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[external data 20f] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


# ---- phase 21: the rest of the GBDT trainer ----------------------------------

#: phase 21: 25 iterations a run at 8c's params; the sweeps' rows and
#: points; the airline shape (benchm-ml's ``airline``, 10M rows; 5M since
#: phase 24 joined the script, 2.5M since phase 26 did, to keep it within
#: its time limit), the
#: rows ``transform`` scores, the EFB prefix compared with a dense model;
#: the HIGGS rows 21a, 21b and 21e fit (the first 2.75M of phase 8's
#: 11M since phase 26 joined the script, for the same reason)
P21 = dict(iters=25, sweep_rows=4096, sweep_points=64,
           airline_rows=1_250_000, transform_rows=1_000_000,
           efb_prefix=250_000, efb_prefix_iters=10, higgs_rows=2_750_000)
#: benchm-ml's airline columns that are categorical, with their levels
#: (the 2007 flights' months, days, carriers and airports)
AIRLINE_CATS = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7),
                ("UniqueCarrier", 22), ("Origin", 300), ("Dest", 300))
#: 21d's bundled bin matrix (its plan, checked there; K6's bundled
#: cases time it at the airline set's full 10M rows): six
#: one-hot groups and two numeric columns in 8 bundles, the widest (300
#: airports, 3 bins each, and the all-default slot) 901 bins as uint16
BUNDLED = dict(rows=10_000_000, bundles=8, bins=901)


def make_airline_like(n, seed=0):
    """benchm-ml's airline rows from ``seed``: the six categorical columns
    as integer codes 1..levels (airports drawn from a Zipf-like
    popularity), DepTime in hhmm and Distance in miles; the label, a
    delay of 15 minutes or more (about one flight in five), from a seeded
    rule of per-category effects (unordered in the codes) and a later
    departure. Returns (X (n, 8) float64, y)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = np.empty((n, 8))
    logit = np.zeros(n)
    for j, (_name, k) in enumerate(AIRLINE_CATS):
        pop = 1.0 / np.arange(1, k + 1) ** (0.9 if k >= 300 else 0.2)
        code = rng.choice(k, size=n, p=pop / pop.sum())
        X[:, j] = code + 1
        logit += rng.normal(0, 0.6 if k >= 22 else 0.3, k)[code]
    minutes = rng.integers(5 * 60, 24 * 60, n)
    X[:, 6] = (minutes // 60) * 100 + minutes % 60
    X[:, 7] = np.round(np.exp(rng.normal(6.4, 0.6, n)))
    logit += 1.2 * minutes / (24 * 60) - 0.05 * np.log(X[:, 7])
    z = logit + rng.logistic(0, 1, n)
    return X, (z > np.quantile(z, 0.8)).astype(np.float64)


def _airline_csr(X):
    """21c's rows one-hot encoded: each categorical column's levels as
    columns of 1.0, then DepTime and Distance: (n, 674) CSR, 8 stored
    values a row."""
    import numpy as np
    import scipy.sparse as sp
    n = len(X)
    offsets = np.cumsum([0] + [k for _, k in AIRLINE_CATS])
    cols = np.empty((n, 8), np.int32)
    for j in range(6):
        cols[:, j] = offsets[j] + X[:, j].astype(np.int32) - 1
    cols[:, 6], cols[:, 7] = offsets[-1], offsets[-1] + 1
    data = np.ones((n, 8))
    data[:, 6:] = X[:, 6:]
    return sp.csr_matrix((data.ravel(), cols.ravel(),
                          np.arange(0, 8 * n + 1, 8)),
                         shape=(n, int(offsets[-1]) + 2))


def _gbdt_module(name):
    import importlib
    return importlib.import_module(f"mmlspark_tpu_torch.models.gbdt.{name}")


class _FirstTreeVsPlain:
    """Within the block, ``train()``'s first tree build is repeated through
    the plain histogram on the same inputs, its g, h and count weights
    in float64: ``kernel`` and ``plain`` hold the two builds' outputs,
    ``args`` the build's inputs. The plain version's float32 sums are
    no reference on the card: its ``index_add_`` adds each slot's rows
    one atomic at a time, and at the first iteration's constant hessian
    that drifts by 1.7e-4 of a 23,000-row slot (K6's block partials, 2e-6;
    measured on an H100), enough to move a split; float64 sums are
    exact to well below either. The plain build's calls are taken off
    ``level_histogram_plain.calls`` (they are the comparison's, not the
    path's)."""

    def __enter__(self):
        from mmlspark_tpu_torch.ops.histogram import level_histogram_plain
        self.mod = _gbdt_module("train")
        self.real = real = self.mod.build_tree
        self.kernel = self.plain = self.args = None

        def spy(*args, **kw):
            out = real(*args, **kw)
            if self.kernel is None:
                calls = level_histogram_plain.calls
                bins, g, h, w = args[:4]
                self.plain = real(bins, g.double(), h.double(), w.double(),
                                  *args[4:], **{**kw, "hist_impl": "plain"})
                level_histogram_plain.calls = calls
                self.kernel, self.args = out, (args, kw)
            return out
        self.mod.build_tree = spy
        return self

    def __exit__(self, *exc):
        self.mod.build_tree = self.real

    def ties(self, what):
        """The two first trees' splits: equal, or ties (``_tree_ties``)."""
        k, p = ([t.cpu().numpy() for t in out]
                for out in (self.kernel, self.plain))
        return _tree_ties(what, (k[0], k[1], k[4]), (p[0], p[1], p[4]))


def _k6_run(what, iters, bins_native=True):
    """The counts of one ``train()`` since :func:`_zero_launch_counts`: 5
    K6 launches an iteration, no plain call (and, with
    ``bins_native``, the bins from the native loop only)."""
    if bins_native:
        return _check_counts(what, iters)
    k6, plain, _native, _numpy = _launch_counts()
    if k6 != 5 * iters or plain:
        raise AssertionError(f"{what}: K6 launches {k6} (want {5 * iters}),"
                             f" plain calls {plain} (want 0)")
    return k6


def _mode_fit(what, params, X, y, **kw):
    """``train(device=None)`` with its K6 launches checked; returns
    (booster, record of its seconds and launches)."""
    from mmlspark_tpu_torch.models.gbdt import train
    iters = params["num_iterations"]
    _zero_launch_counts()
    t0 = time.perf_counter()
    b = train(params, X, y, **kw)
    wall = time.perf_counter() - t0
    ph = b.phase_seconds
    rec = {"train_wall_s": wall, "sec_per_iter": ph["boost"] / iters,
           "k6_launches": _k6_run(what, iters),
           "phase_seconds": dict(ph)}
    return b, rec


HIGGS_P = dict(objective="binary", num_leaves=31, max_bin=255,
               learning_rate=0.1, min_data_in_leaf=20)


def phase_boosting_modes(dev_info, X, y):
    """21a: gbdt, goss, dart and rf at 8c's shape (module docstring)."""
    import numpy as np
    from mmlspark_tpu_torch.models.gbdt import Booster
    iters = P21["iters"]
    base = {**HIGGS_P, "num_iterations": iters}
    modes = {"gbdt": {}, "goss": {"boosting": "goss"},
             "dart": {"boosting": "dart"},
             "rf": {"boosting": "rf", "bagging_fraction": 0.632,
                    "bagging_freq": 1}}
    out, boosters = {}, {}
    # the first train() of the process loads the kernels' library and
    # the runtime's: warm them on a slice, untimed, as 8c does
    _gbdt_module("train").train({**base, "num_iterations": 1},
                                X[:1_000_000], y[:1_000_000])
    for name, extra in modes.items():
        with _FirstTreeVsPlain() as spy:
            b, rec = _mode_fit(f"21a {name}", {**base, **extra}, X, y)
        rec["first_tree_ties"] = spy.ties(f"21a {name} first tree")
        live = spy.args[0][3]
        rec["first_tree_rows"] = float(live.sum().item())
        del spy
        t0 = time.perf_counter()
        p = b.predict(X)
        rec["predict_s"] = time.perf_counter() - t0
        rec["train_auc"] = _auc(y, p)
        if b.num_trees != iters or not np.isfinite(p).all():
            raise AssertionError(f"21a {name}: {b.num_trees} trees, finite "
                                 f"{np.isfinite(p).all()}")
        out[name], boosters[name] = rec, b
        log(f"[21a {name}] {json.dumps(rec)} | {dev_info['smi']}")
    auc0 = out["gbdt"]["train_auc"]
    for name in ("goss", "dart"):
        auc = out[name]["train_auc"]
        if auc <= 0.75 or abs(auc - auc0) > 0.05:
            raise AssertionError(f"21a {name}: train AUC {auc} (gbdt "
                                 f"{auc0}): want > 0.75 and within 0.05")
    # rf averages trees that all fit the starting residual: no boosting,
    # so its guard is the average against one of its trees
    rf = boosters["rf"]
    out["rf"]["first_tree_auc"] = _auc(y, rf.predict(X, num_iteration=1))
    if out["rf"]["train_auc"] <= 0.6 or \
            out["rf"]["train_auc"] < out["rf"]["first_tree_auc"]:
        raise AssertionError(f"21a rf: AUC {out['rf']['train_auc']}, its "
                             f"first tree's {out['rf']['first_tree_auc']}")
    n = len(y)
    selected = int(np.ceil(0.2 * n) + np.ceil(0.1 * n))
    goss = boosters["goss"]
    if goss.covers[0][0] > selected + 1 or \
            out["goss"]["first_tree_rows"] != selected:
        raise AssertionError(f"21a goss: root cover {goss.covers[0][0]}, "
                             f"rows {out['goss']['first_tree_rows']} "
                             f"(selected {selected})")
    ph = out["goss"]["phase_seconds"]
    out["goss"]["host_select_s_per_iter"] = {
        "d2h": ph["goss_d2h"] / iters, "select": ph["goss_select"] / iters}
    dart = boosters["dart"]
    if np.abs(dart.leaf_values).max() > \
            np.abs(boosters["gbdt"].leaf_values).max() + 1e-6:
        raise AssertionError("21a dart: leaves larger than gbdt's")
    p = dart.predict(X)
    if not np.array_equal(Booster.from_string(dart.to_string()).predict(X),
                          p):
        raise AssertionError("21a dart: the model string round trip "
                             "predicts differently")
    raw = boosters["rf"].predict(X, raw_score=True)
    out["rf"]["raw_abs_max"] = float(np.abs(raw).max())
    if out["rf"]["raw_abs_max"] >= 5.0:
        raise AssertionError(f"21a rf: raw scores up to "
                             f"{out['rf']['raw_abs_max']} (the 1/T average "
                             f"stays within one tree's range, < 5)")
    out["sec_per_iter_over_gbdt"] = {
        k: out[k]["sec_per_iter"] / out["gbdt"]["sec_per_iter"]
        for k in modes}
    return out


def _monotone_sweep(b, X, col, sign, points):
    """Predictions of ``b`` along ``points`` values of column ``col``
    (its 1st to 99th percentile) for every row of X: the worst step
    against ``sign`` (0 when monotone)."""
    import numpy as np
    grid = np.quantile(X[:, col], np.linspace(0.01, 0.99, points))
    pts = np.repeat(X, points, axis=0)
    pts[:, col] = np.tile(grid, len(X)).astype(np.float32)
    steps = np.diff(b.predict(pts, raw_score=True).reshape(len(X), points),
                    axis=1) * sign
    return float(max(0.0, -steps.min()))


def _paths_outside_groups(b, groups):
    """Root-to-leaf paths of ``b`` whose split features share no group."""
    import numpy as np
    depth, bad = b.depth, 0
    for tree in np.asarray(b.feats):
        for leaf in range(2 ** depth):
            idx, used = 0, set()
            for d in range(depth):
                if tree[idx] >= 0:
                    used.add(int(tree[idx]))
                idx = 2 * idx + 1 + ((leaf >> (depth - 1 - d)) & 1)
            bad += bool(used) and not any(used <= set(g) for g in groups)
    return bad


def phase_constraints(dev_info, X, y, gbdt):
    """21b: monotone, path_smooth and interaction constraints on HIGGS."""
    groups = [list(range(0, 16)), list(range(10, 28))]
    params = {**HIGGS_P, "num_iterations": P21["iters"],
              "monotone_constraints": [1, -1] + [0] * 26,
              "path_smooth": 10.0, "interaction_constraints": groups}
    b, rec = _mode_fit("21b constraints", params, X, y)
    rows = X[:P21["sweep_rows"]]
    rec["monotone_worst_step"] = {
        "col0_increasing": _monotone_sweep(b, rows, 0, 1, P21["sweep_points"]),
        "col1_decreasing": _monotone_sweep(b, rows, 1, -1,
                                           P21["sweep_points"])}
    rec["paths_outside_groups"] = _paths_outside_groups(b, groups)
    rec["train_auc"] = _auc(y, b.predict(X))
    rec["sec_per_iter_over_gbdt"] = rec["sec_per_iter"] / \
        gbdt["sec_per_iter"]
    log(f"[21b] {json.dumps(rec)} | {dev_info['smi']}")
    if max(rec["monotone_worst_step"].values()) > 1e-6 \
            or rec["paths_outside_groups"]:
        raise AssertionError(f"21b: monotone steps "
                             f"{rec['monotone_worst_step']}, "
                             f"{rec['paths_outside_groups']} paths outside "
                             f"the groups")
    return rec


def phase_linear_tree(dev_info, X, y, gbdt):
    """21e: ``linear_tree`` on HIGGS, 25 iterations."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.gbdt.trees import (fit_linear_leaves,
                                                      path_features)
    iters = P21["iters"]
    params = {**HIGGS_P, "num_iterations": iters, "linear_tree": True}
    with _FirstTreeVsPlain() as spy:
        b, rec = _mode_fit("21e linear_tree", params, X, y)
    rec["first_tree_ties"] = spy.ties("21e first tree")
    (bins, g, h, live), kw = spy.args[0][:4], spy.args[1]
    dev = g.device
    xd = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32)).to(dev)
    coefs = {}
    for impl, out in (("kernel", spy.kernel), ("plain", spy.plain)):
        pf = path_features(out[0].cpu().numpy(), b.depth)
        beta, _ = fit_linear_leaves(
            xd, out[3].to(torch.int64), g, h, live,
            torch.as_tensor(pf).to(dev), n_leaf=2 ** b.depth,
            lam_lin=0.0, lam=1e-10)
        coefs[impl] = beta.cpu().numpy()
    del spy, xd, bins, g, h, live
    torch.cuda.empty_cache()
    # the normal equations sum in float64 on the card: two fits of the
    # same tree part by its rounding only (1e-5 * max|coef|)
    scale = float(np.abs(coefs["plain"]).max())
    err = float(np.abs(coefs["kernel"] - coefs["plain"]).max())
    stored = b.linear["coefs"][0] / np.float32(HIGGS_P["learning_rate"])
    rec.update({
        "first_tree_coef_max_abs_diff": err, "first_tree_coef_scale": scale,
        "stored_vs_kernel_fit_max_abs_diff": float(np.abs(
            stored - coefs["kernel"]).max()),
        "linear_fit_s": rec["phase_seconds"]["linear_fit"],
        "linear_fit_s_per_iter": rec["phase_seconds"]["linear_fit"] / iters,
        "train_auc": _auc(y, b.predict(X)),
        "sec_per_iter_over_gbdt": rec["sec_per_iter"] / gbdt["sec_per_iter"]})
    refused = {}
    for name, fn, exc in (("shap_values", lambda: b.shap_values(X[:8]),
                           NotImplementedError),
                          ("to_onnx", lambda: _gbdt_module(
                              "onnx_export").booster_to_onnx(b),
                           ValueError)):
        try:
            fn()
            refused[name] = False
        except exc:
            refused[name] = True
    rec["refused"] = refused
    log(f"[21e] {json.dumps(rec)} | {dev_info['smi']}")
    if rec["first_tree_ties"] or err > 1e-5 * scale \
            or rec["stored_vs_kernel_fit_max_abs_diff"] > 1e-5 * scale \
            or not all(refused.values()) or rec["train_auc"] <= 0.75:
        raise AssertionError(f"21e: ties {rec['first_tree_ties']}, first "
                             f"tree coefficients {err} apart (scale "
                             f"{scale}), stored "
                             f"{rec['stored_vs_kernel_fit_max_abs_diff']} "
                             f"apart, refused {refused}, AUC "
                             f"{rec['train_auc']}")
    return rec


def phase_categorical(dev_info, X, y, data_s):
    """21c: the airline shape through ``LightGBMClassifier.fit``."""
    import numpy as np
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier
    iters = P21["iters"]
    df = DataFrame({"features": X, "label": y})
    kw = dict(num_leaves=31, max_bin=255, learning_rate=0.1,
              min_data_in_leaf=20, num_iterations=iters)
    recs, models = {}, {}
    for name, extra in (("categorical", {"categorical_feature":
                                         list(range(6))}),
                        ("numeric", {})):
        est = LightGBMClassifier(**kw, **extra)
        _zero_launch_counts()
        t0 = time.perf_counter()
        model = est.fit(df)
        fit_s = time.perf_counter() - t0
        b = model.booster
        ph = b.phase_seconds
        recs[name] = {"time_to_model_s": fit_s,
                      "sec_per_iter": ph["boost"] / iters,
                      "k6_launches": _k6_run(f"21c {name}", iters),
                      "phase_seconds": dict(ph),
                      "train_auc": _auc(y, b.predict(X))}
        models[name] = model
    cat = recs["categorical"]
    cat["encoder_host_s"] = cat["phase_seconds"]["cat_encode"]
    rows = P21["transform_rows"]
    model = models["categorical"]
    t0 = time.perf_counter()
    out = model.transform(DataFrame({"features": X[:rows]}))
    cat["transform_s"] = time.perf_counter() - t0
    prob = np.stack(out["probability"])[:, 1]
    cat["transform_prob_max_abs_diff"] = float(np.abs(
        prob - model.booster.predict(X[:rows])).max())
    rec = {"rows": len(y), "positives": float(y.mean()), "data_s": data_s,
           **recs, "auc_gain": cat["train_auc"] - recs["numeric"]["train_auc"]}
    log(f"[21c] {json.dumps(rec)} | {dev_info['smi']}")
    if cat["train_auc"] < recs["numeric"]["train_auc"] \
            or cat["transform_prob_max_abs_diff"] > 1e-6:
        raise AssertionError(f"21c: AUC {cat['train_auc']} with "
                             f"categorical_feature vs "
                             f"{recs['numeric']['train_auc']} without; "
                             f"transform off by "
                             f"{cat['transform_prob_max_abs_diff']}")
    return rec


def phase_efb(dev_info, X, y, hist_recs=None):
    """21d: 21c's rows one-hot, sparse, through ``train()`` with EFB."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.gbdt import train
    iters = P21["iters"]
    t0 = time.perf_counter()
    csr = _airline_csr(X)
    csr_s = time.perf_counter() - t0
    params = {**HIGGS_P, "num_iterations": iters}
    _zero_launch_counts()
    t0 = time.perf_counter()
    b = train(params, csr, y)
    wall = time.perf_counter() - t0
    ph = b.phase_seconds
    plan = b.efb_plan
    rec = {"rows": csr.shape[0], "features": csr.shape[1], "nnz": csr.nnz,
           "csr_build_s": csr_s, "train_wall_s": wall,
           "k6_launches": _k6_run("21d EFB", iters, bins_native=False),
           "efb_plan": plan, "phase_seconds": dict(ph),
           "sec_per_iter": ph["boost"] / iters,
           "train_auc": _auc(y, b.predict(csr))}
    if plan is None or (plan["n_bundles"], plan["n_bundle_bins"]) != (
            BUNDLED["bundles"], BUNDLED["bins"]):
        raise AssertionError(f"21d: plan {plan}, want {BUNDLED}")
    # K6 at the bundled shape (8a's cases of it, when 8a ran)
    recs = hist_recs or {}
    rec["k6_bundled"] = {
        label: recs.get(label) or _hist_case(dev_info, label, *shape, **opts)
        for label, *shape, opts in bundled_hist_cases()}
    torch.cuda.empty_cache()
    # a prefix whose dense one-hot fits the host: EFB against dense bins
    m = P21["efb_prefix"]
    p = {**params, "num_iterations": P21["efb_prefix_iters"]}
    part = csr[:m]
    efb = train(p, part, y[:m])
    dense = train(p, part.toarray().astype(np.float32), y[:m])
    trees, ties = _model_ties("21d prefix", efb, dense)
    scale = float(np.abs(dense.leaf_values[:trees]).max(initial=0.0))
    leaf_err = float(np.abs(efb.leaf_values[:trees]
                            - dense.leaf_values[:trees]).max(initial=0.0))
    rec["prefix"] = {"rows": m, "iterations": p["num_iterations"],
                     "efb_plan": efb.efb_plan, "trees_equal": trees,
                     "tie": ties, "leaf_max_abs_diff": leaf_err,
                     "leaf_scale": scale, "dense_bin_transform_s":
                         dense.phase_seconds["bin_transform"]}
    log(f"[21d] {json.dumps(rec)} | {dev_info['smi']}")
    # each feature's default bin is the node total less its other bins,
    # so a small child's stats carry K6's rounding of its parent's sums
    # (2e-6 of the parent's summed |g|), divided by the child's own small
    # hessian: 6.9e-4 of the largest leaf measured on an H100
    if leaf_err > 2e-3 * scale or rec["train_auc"] <= 0.6:
        raise AssertionError(f"21d: prefix leaves {leaf_err} apart (scale "
                             f"{scale}) over {trees} equal trees, AUC "
                             f"{rec['train_auc']}")
    return rec


def _model_ties(what, a, b, rel=1e-4):
    """Two models' trees in order: equal splits, until a tree whose first
    differing node is a tie: the two gains within ``rel`` of the tree's
    largest gain. Two histograms of the same rows built differently (EFB
    against dense bins: other atomic orders, the default bin by
    subtraction) part by K6's rounding, 2e-6 of a slot's summed |g|,
    and a gain, a small difference of G^2 / H terms, moves by about
    2 |G / H| times that: at a deep node of a late tree 1e-3 of its own
    size, 1e-4 of the tree's largest. The trees after it fit other
    scores and are not compared. Returns (the equal trees, the tie's
    record or None)."""
    import numpy as np
    for t in range(min(a.num_trees, b.num_trees)):
        fa, ta, ga = a.feats[t], a.thr_raw[t], a.gains[t]
        fb, tb, gb = b.feats[t], b.thr_raw[t], b.gains[t]
        diff = np.nonzero((fa != fb) | (ta != tb))[0]
        if not len(diff):
            continue
        i = int(diff[0])
        top = float(np.abs(gb).max())
        gap = abs(float(ga[i]) - float(gb[i]))
        tie = {"tree": t, "node": i, "a": [int(fa[i]), float(ta[i])],
               "b": [int(fb[i]), float(tb[i])], "gain_a": float(ga[i]),
               "gain_b": float(gb[i]), "tree_max_gain": top,
               "gap_over_tree_max": gap / max(top, 1e-30)}
        log(f"[{what}] {json.dumps(tie)}")
        if gap > rel * top:
            raise AssertionError(f"{what}: tree {t} node {i} splits differ "
                                 f"by {gap / max(top, 1e-30):.3g} of the "
                                 f"tree's largest gain (a tie is <= {rel})")
        return t, tie
    return min(a.num_trees, b.num_trees), None


def bundled_hist_cases():
    """K6 at 21d's bundled shape (8a's cases too): uint16 bins carried as
    int16, 901 bundle bins, 8 bundles of 10M rows, 1 and 16 nodes."""
    import torch
    return [(f"bundled_nodes{k}", BUNDLED["rows"], BUNDLED["bundles"], k,
             BUNDLED["bins"], 30 + k, {"bin_dtype": torch.int16})
            for k in (1, 16)]


#: phase 22: (a) MSLR-WEB30K's published shape (136 features; Fold1's
#: training split has three fifths of its 31,531 queries, 18,919, and
#: 3,771,125 rows; a quarter of those queries since phase 27 joined the
#: script, to keep it within its time limit) with a fifth more queries held
#: out;
#: (b) and (c) on 8c's HIGGS shape (b on its first 2,750,000 rows since
#: phase 27 joined, c on its first million); (d) and (e) BERT-base
#: fine-tuning at BERT's published GLUE settings (seq 128, batch 32, Adam
#: lr 5e-5)
P22 = dict(queries=4_730, held_out=946, features=136, mean_docs=120,
           max_docs=1_251, iters=50, grad_groups=128, extra_rows=2_750_000,
           ckpt_rows=1_000_000,
           ckpt_first=25, ckpt_interval=5, bert_rows=2_048, bert_seq=128,
           bert_batch=32, lr=5e-5, lora_rows=1_024, lora_rank=8,
           serve_rows=256, markers=16)


def make_mslr_like(n_queries, seed=0):
    """MSLR-WEB30K-shaped rows from ``seed``: query sizes lognormal with
    mean P22["mean_docs"], one query of P22["max_docs"] documents (the
    published largest); 136 standard-normal float32 features; relevance
    0-4 from a per-query offset plus a rule over 12 features, cut at
    MSLR's label shares (52%, 31%, 13%, 3%, 1%). Returns (X, y, query id
    per row, query sizes)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = np.clip(np.round(rng.lognormal(np.log(P22["mean_docs"]) - 0.245,
                                           0.7, n_queries)),
                    1, P22["max_docs"]).astype(np.int64)
    sizes[rng.integers(min(n_queries, P22["queries"]))] = P22["max_docs"]
    n = int(sizes.sum())
    F = P22["features"]
    X = rng.standard_normal((n, F), dtype=np.float32)
    w = np.zeros(F, np.float32)
    w[rng.choice(F, 12, replace=False)] = rng.normal(0, 1, 12)
    z = (X @ w) / np.sqrt(12.0) + np.repeat(rng.normal(0, 0.5, n_queries),
                                            sizes) + rng.normal(0, 0.7, n)
    y = np.searchsorted(np.quantile(z, [0.52, 0.83, 0.96, 0.99]),
                        z).astype(np.float64)
    return X, y, np.repeat(np.arange(n_queries), sizes), sizes


def _ndcg_at10(y, p, sizes):
    """Mean NDCG@10 over the queries with a relevant document (ties in
    score keep document order)."""
    import numpy as np
    offs = np.concatenate([[0], np.cumsum(sizes)])
    vals = []
    for lo, hi in zip(offs[:-1], offs[1:]):
        yy, pp = y[lo:hi], p[lo:hi]
        k = min(10, hi - lo)
        disc = 1.0 / np.log2(np.arange(2, k + 2))
        ideal = ((2.0 ** np.sort(yy)[::-1][:k] - 1) * disc).sum()
        if ideal > 0:
            top = np.argsort(-pp, kind="stable")[:k]
            vals.append(((2.0 ** yy[top] - 1) * disc).sum() / ideal)
    return float(np.mean(vals))


def _rank_grads_vs_plain(X_sizes, y, seed):
    """22a's gradient check: ``P22["grad_groups"]`` training queries, the
    largest among them, on the card against the plain version on the host, at
    iteration 0's tied scores and at scores rounded to 0.01 (ties inside
    groups). Returns the worst errors over max|g| and max|h|."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.gbdt.lambdarank import (
        LambdarankPlan, lambdarank_grad, lambdarank_grad_plain)
    sizes = X_sizes
    rng = np.random.default_rng(seed)
    big = int(np.argmax(sizes))
    rest = np.delete(np.arange(len(sizes)), big)
    pick = np.sort(np.concatenate([[big], rng.choice(
        rest, P22["grad_groups"] - 1, replace=False)]))
    offs = np.concatenate([[0], np.cumsum(sizes)])
    rows = np.concatenate([np.arange(offs[q], offs[q + 1]) for q in pick])
    gs, yy = sizes[pick], y[rows]
    plan = LambdarankPlan(gs, yy, torch.device("cuda"))
    out = {"groups": len(pick), "rows": int(len(rows)),
           "largest": int(gs.max())}
    for name, s in (("tied", np.zeros(len(rows))),
                    ("rounded", np.round(rng.normal(0, 1, len(rows)), 2))):
        gd, hd = (t.cpu().numpy() for t in lambdarank_grad(
            torch.from_numpy(s).cuda(), plan))
        gp, hp = lambdarank_grad_plain(s, yy, gs)
        eg = float(np.abs(gd - gp).max() / np.abs(gp).max())
        eh = float(np.abs(hd - hp).max() / np.abs(hp).max())
        out[name] = {"g_err_over_max": eg, "h_err_over_max": eh}
        if not (eg <= 1e-12 and eh <= 1e-12):
            raise AssertionError(f"22a grads ({name}): card vs plain "
                                 f"{eg:.3g} / {eh:.3g} of max (want <= "
                                 f"1e-12)")
    return out


def phase_ranker(dev_info):
    """22a: ``LightGBMRanker.fit`` at MSLR-WEB30K's shape (module
    docstring)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.gbdt import LightGBMRanker
    from mmlspark_tpu_torch.models.gbdt.lambdarank import (LambdarankPlan,
                                                           lambdarank_grad)
    Q, iters = P22["queries"], P22["iters"]
    t0 = time.perf_counter()
    X, y, qid, sizes = make_mslr_like(Q + P22["held_out"], seed=22)
    n_tr = int(sizes[:Q].sum())
    rec = {"rows": n_tr, "queries": Q, "features": P22["features"],
           "held_out_rows": int(len(y) - n_tr),
           "data_s": time.perf_counter() - t0,
           "grads": _rank_grads_vs_plain(sizes[:Q], y[:n_tr], 5)}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    plan = LambdarankPlan(sizes[:Q], y[:n_tr], dev)
    rec["grad_plan_s"] = time.perf_counter() - t0
    s = torch.randn(n_tr, device=dev)
    rec["grad_s_per_iter"] = _cuda_ms([lambda: lambdarank_grad(s, plan)],
                                      3) / 1e3
    rec["grad_pair_elements"] = plan.pair_elements()
    del plan, s
    torch.cuda.empty_cache()
    df = DataFrame({"features": X[:n_tr], "label": y[:n_tr],
                    "group": qid[:n_tr]})
    est = LightGBMRanker(device=None, num_iterations=iters, **{
        k: v for k, v in HIGGS_P.items() if k != "objective"})
    _zero_launch_counts()
    with _FirstTreeVsPlain() as spy:
        t0 = time.perf_counter()
        model = est.fit(df)
        rec["fit_s"] = time.perf_counter() - t0
    rec["k6_launches"] = _check_counts("22a", iters)
    rec["first_tree_ties"] = spy.ties("22a first tree")
    del spy
    b = model.booster
    ph = b.phase_seconds
    rec["sec_per_iter"] = ph["boost"] / iters
    rec["phase_seconds"] = dict(ph)
    Xh, yh, sh = X[n_tr:], y[n_tr:], sizes[Q:]
    rec["ndcg10_held_out"] = _ndcg_at10(yh, b.predict(Xh, raw_score=True),
                                        sh)
    rec["ndcg10_first_tree"] = _ndcg_at10(
        yh, b.predict(Xh, raw_score=True, num_iteration=1), sh)
    if b.num_trees != iters or \
            rec["ndcg10_held_out"] <= rec["ndcg10_first_tree"]:
        raise AssertionError(f"22a: {b.num_trees} trees, held-out NDCG@10 "
                             f"{rec['ndcg10_held_out']} (first tree "
                             f"{rec['ndcg10_first_tree']})")
    out = model.transform(DataFrame({"features": Xh[:1000]}))
    if not np.array_equal(np.asarray(out["prediction"]),
                          b.predict(Xh[:1000], raw_score=True).astype(
                              np.float64)):
        raise AssertionError("22a: transform's prediction is not the raw "
                             "score")
    del df, model, b, out
    torch.cuda.empty_cache()
    rec["k6"] = {f"nodes{k}": _hist_case(dev_info, f"ranker_nodes{k}", n_tr,
                                         P22["features"], k, 255, 40 + k)
                 for k in (1, 16)}
    log(f"[22a] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


class _BuildRecorder:
    """Within the block, every ``build_tree`` call of ``train()`` keeps
    its key, ``feat_bins`` and (feats, thr_bin) outputs (K6's builds, on
    the card)."""

    def __enter__(self):
        self.mod = _gbdt_module("train")
        self.real = real = self.mod.build_tree
        self.calls = []

        def spy(*args, **kw):
            out = real(*args, **kw)
            self.calls.append((kw.get("rng"), kw.get("feat_bins"),
                               out[0], out[1]))
            return out
        self.mod.build_tree = spy
        return self

    def __exit__(self, *exc):
        self.mod.build_tree = self.real


def _check_draws(what, calls, F, depth, ff_bynode):
    """Every recorded tree against its own key's draws: each split's bin
    is the node's drawn candidate for the split feature (so below the
    feature's ``feat_bins``), and the feature is in the node's drawn
    subset of round(F * ff_bynode). Returns the nodes checked."""
    import torch
    from mmlspark_tpu_torch.utils import prng
    kk = max(1, int(round(F * ff_bynode)))
    checked = 0
    for t, (key, feat_bins, feats, thr) in enumerate(calls):
        bin_hi = (feat_bins - 1).clamp_min(1).long()
        for d in range(depth):
            m, off = 2 ** d, 2 ** d - 1
            f = feats[off:off + m].long()
            b = thr[off:off + m].long()
            live = f >= 0
            fc = f.clamp_min(0)
            u = prng.uniform(prng.fold_in(key, 2 * d), (m, F))
            r = torch.minimum((u * bin_hi[None]).long(), bin_hi[None] - 1)
            cand = r.gather(1, fc[:, None])[:, 0]
            u = prng.uniform(prng.fold_in(key, 2 * d + 1), (m, F))
            subset = u >= torch.topk(u, kk, dim=1).values[:, -1:]
            in_subset = subset.gather(1, fc[:, None])[:, 0]
            below = b < feat_bins.long()[fc]
            bad = live & ~((b == cand) & in_subset & below)
            if bool(bad.any()):
                raise AssertionError(
                    f"{what}: tree {t} level {d}: {int(bad.sum())} splits "
                    f"off their node's draws")
            checked += int(live.sum())
    return checked


def phase_extra_trees(dev_info, X, y):
    """22b: ``extra_trees`` with ``feature_fraction_bynode`` 0.5 on 8c's
    HIGGS shape beside gbdt (module docstring)."""
    import torch
    from mmlspark_tpu_torch.utils import prng
    draws = 0
    for seed in (0, 1, 2 ** 31 - 1):
        kc, kh = prng.PRNGKey(seed, "cuda"), prng.PRNGKey(seed)
        for d in (0, 3, 999_999):
            fc, fh = prng.fold_in(kc, d), prng.fold_in(kh, d)
            for shape in ((1, 28), (16, 28), (64, 136)):
                uc, uh = prng.uniform(fc, shape), prng.uniform(fh, shape)
                if not torch.equal(uc.cpu().view(torch.int32),
                                   uh.view(torch.int32)):
                    raise AssertionError(f"22b: threefry draws of seed "
                                         f"{seed}, data {d} differ between "
                                         f"the card and the CPU")
                draws += uc.numel()
        if not torch.equal(prng.split(kc, 7).cpu(), prng.split(kh, 7)):
            raise AssertionError("22b: split keys differ card vs CPU")
    iters = P22["iters"]
    base = {**HIGGS_P, "num_iterations": iters}
    gb, grec = _mode_fit("22b gbdt", base, X, y)
    rec = {"threefry_draws_compared": draws,
           "gbdt": {"sec_per_iter": grec["sec_per_iter"],
                    "train_auc": _auc(y, gb.predict(X))}}
    del gb
    params = {**base, "extra_trees": True, "feature_fraction_bynode": 0.5}
    with _FirstTreeVsPlain() as spy, _BuildRecorder() as recd:
        b, r = _mode_fit("22b", params, X, y)
    rec.update(sec_per_iter=r["sec_per_iter"], k6_launches=r["k6_launches"],
               gbdt_k6_launches=grec["k6_launches"],
               phase_seconds=r["phase_seconds"],
               first_tree_ties=spy.ties("22b first tree"),
               nodes_checked=_check_draws("22b", recd.calls, X.shape[1],
                                          5, 0.5),
               train_auc=_auc(y, b.predict(X)))
    del spy, recd
    auc0 = rec["gbdt"]["train_auc"]
    if rec["train_auc"] <= 0.75 or abs(rec["train_auc"] - auc0) > 0.05:
        raise AssertionError(f"22b: train AUC {rec['train_auc']} (gbdt "
                             f"{auc0}): want > 0.75 and within 0.05")
    log(f"[22b] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_checkpoints(dev_info, X, y):
    """22c: step checkpoints on HIGGS's first million rows (module
    docstring)."""
    import shutil
    import numpy as np
    from mmlspark_tpu_torch.models.gbdt import Booster
    from mmlspark_tpu_torch.utils.checkpoint import TrainingCheckpointer
    n, first = P22["ckpt_rows"], P22["ckpt_first"]
    Xs, ys = X[:n], y[:n]
    d = os.path.join(HERE, "build", "phase22_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    p = {**HIGGS_P, "checkpoint_dir": d,
         "checkpoint_interval": P22["ckpt_interval"]}
    _b1, r1 = _mode_fit("22c first call", {**p, "num_iterations": first},
                        Xs, ys)
    ck = TrainingCheckpointer(d)
    step, files = ck.latest()
    meta = TrainingCheckpointer.read_json(files["meta.json"])
    text = TrainingCheckpointer.read_text(files["booster.txt"])
    if step != first or meta["completed_iterations"] != first:
        raise AssertionError(f"22c: the first call left step {step}, meta "
                             f"{meta}")
    iters = P22["iters"]
    _zero_launch_counts()
    b2 = _gbdt_module("train").train({**p, "num_iterations": iters}, Xs, ys)
    # the resumed call trains only the iterations after the checkpoint
    k6_resumed = _check_counts("22c resumed", iters - first)
    r2 = {"sec_per_iter": b2.phase_seconds["boost"] / (iters - first)}
    step2, files2 = ck.latest()
    meta2 = TrainingCheckpointer.read_json(files2["meta.json"])
    saved = Booster.from_string(text)
    if step2 != iters or meta2["completed_iterations"] != iters or \
            b2.num_trees != iters:
        raise AssertionError(f"22c: resumed call left step {step2}, meta "
                             f"{meta2}, {b2.num_trees} trees")
    for name in ("feats", "thr_raw", "leaf_values", "gains", "covers"):
        if not np.array_equal(getattr(b2, name)[:first],
                              getattr(saved, name)):
            raise AssertionError(f"22c: the resumed model's first {first} "
                                 f"trees' {name} are not the checkpoint's")
    b3, r3 = _mode_fit("22c uninterrupted", {**HIGGS_P,
                                              "num_iterations": iters},
                       Xs, ys)
    equal, tie = _model_ties("22c resumed vs uninterrupted", b3, b2)
    scale = float(np.abs(b3.leaf_values).max())
    leaf_err = float(np.abs(b2.leaf_values[:equal]
                            - b3.leaf_values[:equal]).max()) if equal else 0.0
    if leaf_err > 2e-3 * scale:
        raise AssertionError(f"22c: leaves {leaf_err} apart over {equal} "
                             f"equal trees (scale {scale})")
    shutil.rmtree(d, ignore_errors=True)
    rec = {"rows": n, "resumed_at": meta["completed_iterations"],
           "saved_at": meta2["completed_iterations"],
           "equal_trees": equal, "tie": tie, "leaf_err": leaf_err,
           "leaf_scale": scale,
           "sec_per_iter": {"first": r1["sec_per_iter"],
                            "resumed": r2["sec_per_iter"],
                            "uninterrupted": r3["sec_per_iter"]},
           "k6_launches": r1["k6_launches"] + k6_resumed + r3["k6_launches"]}
    log(f"[22c] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def glue_like_rows(n, seq, vocab, seed):
    """A GLUE-shaped sentence classification set from ``seed``: right-
    padded rows of ``seq`` ids (lengths 32 ... seq), the first id one of
    P22["markers"] marker tokens, the rest uniform over the vocabulary;
    the label is 1 for the first half of the markers. Returns (ids,
    mask, labels), int64."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, vocab, (n, seq)).astype(np.int64)
    marker = rng.integers(0, P22["markers"], n)
    ids[:, 0] = 100 + marker
    lens = rng.integers(32, seq + 1, n)
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int64)
    ids = ids * mask
    return ids, mask, (marker < P22["markers"] // 2).astype(np.int64)


class _TimedLog(list):
    """An ``eval_log`` that notes the clock at each append."""

    def __init__(self):
        super().__init__()
        self.t = []

    def append(self, x):
        self.t.append(time.perf_counter())
        super().append(x)


def _flash_step_counts(what, steps):
    """K7 / K8a / K8b since ``_zero_gen_counts``: 12 of each a step (one
    per layer), no plain call and no dense attention on the card."""
    from mmlspark_tpu_torch.onnx import convert
    k7, k8a, k8b, plain = _flash_counts()
    want = 12 * steps
    dense = dict(convert.dense_on_cuda)
    if (k7, k8a, k8b) != (want, want, want) or plain or dense:
        raise AssertionError(f"{what}: K7/K8a/K8b {k7}/{k8a}/{k8b} (want "
                             f"{want} each), {plain} plain calls, dense "
                             f"attention on the card {dense}")
    return {"k7": k7, "k8a": k8a, "k8b": k8b}


def _bert_parity(cfg, params, head, clf, feeds):
    """22d's first step: the fused classifier's loss and gradients
    (``value_and_grad``: K7 forward, K8a/K8b backward) against the same
    params through the decomposed graph (``export_bert_onnx(opset=17)``,
    dense attention) with the head in torch, on the card."""
    import torch
    from mmlspark_tpu_torch.models.zoo.bert_onnx import export_bert_onnx
    from mmlspark_tpu_torch.onnx import convert, convert_model
    from mmlspark_tpu_torch.onnx import train as T
    dev = torch.device("cuda")
    cm = convert_model(clf)
    _zero_gen_counts()
    convert.dense_on_cuda.clear()
    loss_f, grads = T.value_and_grad(cm, output="loss")(cm.params, feeds)
    torch.cuda.synchronize()
    counts = _flash_step_counts("22d first step", 1)
    dec = convert_model(export_bert_onnx(cfg, opset=17, params=params))
    P = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
         for k, v in dec.params.items()}
    W, bb = (torch.from_numpy(a).to(dev).requires_grad_(True) for a in head)
    ft = {k: torch.from_numpy(v).to(dev) for k, v in feeds.items()}
    hid = dec(P, {k: ft[k] for k in ("input_ids", "attention_mask")})
    loss_d = torch.nn.functional.cross_entropy(
        hid["last_hidden_state"][:, 0] @ W + bb, ft["labels"])
    lf, ld = float(loss_f), float(loss_d.detach())
    names = list(P)
    gd = dict(zip(names + ["head.w", "head.b"], torch.autograd.grad(
        loss_d, [P[k] for k in names] + [W, bb])))
    for i in range(cfg.layers):
        for s in ("w", "b"):
            gd[f"l{i}.qkv.{s}"] = torch.cat(
                [gd[f"l{i}.{n}.{s}"] for n in "qkv"], dim=-1)
    rel = abs(lf - ld) / abs(ld)
    worst = 0.0
    for k, g in grads.items():
        err = float((g - gd[k]).abs().max())
        top = float(gd[k].abs().max())
        worst = max(worst, err / max(top, 1e-30))
        if err > 1e-4 * top:
            raise AssertionError(f"22d: gradient of {k} off by {err} (max "
                                 f"|g| {top})")
    if rel > 1e-5:
        raise AssertionError(f"22d: first-step loss {lf} vs the "
                             f"decomposed graph's {ld}")
    del P, grads, gd, hid
    torch.cuda.empty_cache()
    return {"loss_fused": lf, "loss_decomposed": ld,
            "loss_rel_err": rel, "grad_err_over_max": worst,
            "launches": counts}


def _served(what, model, cm, frame, ids, mask, base_logits=None):
    """``model.transform`` of ``frame`` on the card against a direct
    forward with its ``weights_override`` layered over the graph's
    params; returns (logits, max error over max |logits|)."""
    import io
    import numpy as np
    import torch
    out = np.stack(list(model.transform(frame)["logits"]))
    with np.load(io.BytesIO(model.get("weights_override"))) as z:
        ov = {k: z[k] for k in z.files}
    params = {k: torch.from_numpy(np.asarray(v)).cuda()
              for k, v in {**cm.params, **ov}.items()}
    with torch.no_grad():
        ref = cm.pruned(["logits"])(params, {
            "input_ids": torch.from_numpy(ids).cuda(),
            "attention_mask": torch.from_numpy(mask).cuda()})["logits"]
    ref = ref.cpu().numpy()
    err = float(np.abs(out - ref).max() / np.abs(ref).max())
    if err > 1e-5 or not np.isfinite(out).all():
        raise AssertionError(f"{what}: served logits {err:.3g} of max off a "
                             f"direct forward with the override")
    if base_logits is not None and np.array_equal(out, base_logits):
        raise AssertionError(f"{what}: served logits equal the base graph's")
    return out, err


def phase_onnx_finetune(dev_info):
    """22d and 22e: ``ONNXEstimator.fit`` of the fused BERT-base, full and
    LoRA (module docstring)."""
    import io
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.onnx_estimator import ONNXEstimator
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    from mmlspark_tpu_torch.models.zoo.bert_onnx import (BertOnnxConfig,
                                                         init_bert_params)
    from mmlspark_tpu_torch.onnx import convert, convert_model
    from mmlspark_tpu_torch.onnx import train as T
    cfg = BertOnnxConfig(**BERT_ONNX)
    params = init_bert_params(cfg, seed=22)
    rng = np.random.default_rng(22)
    head = (rng.normal(0, 0.02, (cfg.d_model, 2)).astype(np.float32),
            np.zeros(2, np.float32))
    t0 = time.perf_counter()
    clf = fused_bert_onnx(cfg, params, head=head)
    build_s = time.perf_counter() - t0
    bs, seq = P22["bert_batch"], P22["bert_seq"]
    ids, mask, labels = glue_like_rows(P22["bert_rows"], seq, cfg.vocab, 22)
    parity = _bert_parity(cfg, params, head, clf, {
        "input_ids": ids[:bs], "attention_mask": mask[:bs],
        "labels": labels[:bs]})
    del params
    cm = convert_model(clf)
    feed = {"input_ids": "ids", "attention_mask": "mask"}
    srv = P22["serve_rows"]
    serve = DataFrame({"ids": ids[:srv], "mask": mask[:srv]})
    base_logits = np.stack(list(ONNXModel(
        clf, device=None, feed_dict=feed, fetch_dict={"logits": "logits"}
    ).transform(serve)["logits"]))
    out = {"22d": {"parity": parity, "graph_build_s": build_s}}
    for part, rows, extra in (("22d", P22["bert_rows"], {}),
                              ("22e", P22["lora_rows"],
                               {"lora_rank": P22["lora_rank"]})):
        steps = rows // bs
        log_ = _TimedLog()
        est = ONNXEstimator(clf, device=None, eval_log=log_, feed_dict=feed,
                            fetch_dict={"logits": "logits"},
                            loss_output="loss", label_input="labels",
                            batch_size=bs, learning_rate=P22["lr"],
                            epochs=1, seed=22, **extra)
        frame = DataFrame({"ids": ids[:rows], "mask": mask[:rows],
                           "label": labels[:rows]})
        seen = {}
        real = T.make_lora_train_step

        def spy(*a, **kw):
            # 22e's base params and optimizer, as the estimator's LoRA
            # step gets them
            step, init = real(*a, **kw)

            def step2(base, lora, state, feeds):
                if "base" not in seen:
                    seen.update(base=base, state=state, snap={
                        k: v.clone() for k, v in base.items()})
                return step(base, lora, state, feeds)
            return step2, init
        T.make_lora_train_step = spy
        try:
            _zero_gen_counts()
            convert.dense_on_cuda.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = est.fit(frame)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        finally:
            T.make_lora_train_step = real
        launches = _flash_step_counts(f"{part} fit", steps)
        losses = np.array(log_, dtype=np.float64)
        first, last = losses[:8].mean(), losses[-8:].mean()
        step_s = (log_.t[-1] - log_.t[0]) / (len(log_.t) - 1)
        rec = {"steps": len(losses), "fit_s": fit_s, "s_per_step": step_s,
               "sequences_per_s": bs / step_s,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "loss_first8": first, "loss_last8": last,
               "launches": launches}
        # full fine-tuning must learn; LoRA's adapters start at a zero
        # delta and move by lr a step, so only its losses are recorded
        if len(losses) != steps or not np.isfinite(losses).all() or \
                (part == "22d" and not last < first):
            raise AssertionError(f"{part}: {len(losses)} steps (want "
                                 f"{steps}), loss {first} -> {last}")
        if part == "22e":
            targets = T.lora_targets(cm, P22["lora_rank"])
            with np.load(io.BytesIO(model.get("weights_override"))) as z:
                names = sorted(z.files)
            trained = [p for g in seen["state"].optimizer.param_groups
                       for p in g["params"]]
            adapters = [t for ab in seen["state"].leaves.values()
                        for t in ab.values()]
            same = all(torch.equal(seen["base"][k], seen["snap"][k])
                       for k in seen["snap"])
            if names != targets or not same or len(trained) != \
                    len(adapters) or any(a is not b for a, b in
                                         zip(trained, adapters)):
                raise AssertionError(f"22e: override names {len(names)} "
                                     f"(targets {len(targets)}), base "
                                     f"unchanged {same}, {len(trained)} "
                                     f"tensors trained")
            rec.update(adapted_matrices=len(targets), adapter_params=sum(
                t.numel() for t in adapters), base_unchanged=same)
            del seen["base"], seen["snap"], seen["state"]
        _, rec["served_err_over_max"] = _served(part, model, cm, serve,
                                                ids[:srv], mask[:srv],
                                                base_logits)
        out[part] = {**out.get(part, {}), **rec}
        log(f"[{part}] {json.dumps(out[part])} | {dev_info['smi']}")
        del model, est
        torch.cuda.empty_cache()
    return out


# phase 23: the tuner and the periphery that computed with jax (no hand
# kernel on these paths: matmuls, gathers, index_add_, torch.linalg.solve)
P23 = dict(
    # 23a: LIBSVM rcv1.binary's shape (677,399 rows, 47,236 features; its
    # 20,242-row split held out), 20-150 non-zeros a row
    vw_rows=677_399, vw_features=47_236, vw_nnz=(20, 150), vw_bits=18,
    vw_batch=64, vw_passes=2, vw_held_out=20_242, vw_parity_rows=65_536,
    vw_profile_steps=256, feat_rows=100_000, feat_check_rows=1_000,
    cb_events=65_536, cb_actions=4, cb_segments=16, cb_cpu_events=8_192,
    # 23b: ANN-benchmarks' sift-128-euclidean shape (SIFT1M)
    knn_corpus=1_000_000, knn_dim=128, knn_queries=10_000, knn_k=100,
    knn_check=256, knn_centers=1_000,
    # 23c: MovieLens-1M's shape (GroupLens ml-1m README)
    sar_users=6_040, sar_items=3_706, sar_ratings=1_000_209,
    sar_pairs=100_000,
    # 23d: two tenants, each 10,000 users x 2,000 resources, 500,000 accesses
    aa_tenants=2, aa_users=10_000, aa_res=2_000, aa_accesses=500_000,
    aa_depts=8, aa_bridges=64, aa_rank=10, aa_iters=25, aa_test=10_000,
    # 23e: phase 11's 2,048 rows as four partitions, in batches of 256 by
    # default (the converter keeps a batch's every intermediate until the
    # graph ends, so four concurrent partitions at 512 peaked at 72 GB)
    tune_parts=(37, 129, 511, 1371), tune_batch=256)


def _dev23():
    import torch
    return torch.device("cuda")


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activity): (result,
    wall s, device-busy s, kernel launches). Busy is the device events'
    summed time (kernels, copies and fills on one stream, so they do not
    overlap); the CPU ops that launched them carry the same time as their
    self device time and are not counted again. Busy is None (not
    measured) when launches were recorded but no device event: CUPTI
    dropped them (seen once, on a one-launch window late in a full run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in ev if e.device_type == DeviceType.CUDA) / 1e6
    launches = sum(e.count for e in ev if "LaunchKernel" in e.key)
    if launches and not busy:
        busy = None
    return out, wall, busy, launches


def _share(wall, busy):
    return {"wall_s": wall, "device_busy_s": busy,
            "host_share": (1.0 - busy / wall) if busy is not None
            and wall > 0 else None}


def _peak_gb():
    import torch
    return torch.cuda.max_memory_allocated() / 1e9


def rcv1_like(n, n_feat, nnz, seed, w=None):
    """``n`` rows of an rcv1-shaped sparse set from ``seed``: 20-150
    non-zeros a row over ``n_feat`` features, popularity ~ u^3 (a Zipf-like
    tail), positive values L2-normalized per row; label 1 where a planted
    sparse linear rule (``w`` over the 100 most frequent features, drawn
    when None) is positive. Returns (rows of (uint32 ids, float32 values),
    labels, w)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(nnz[0], nnz[1] + 1, n)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    idx = (n_feat * rng.random(int(off[-1])) ** 3).astype(np.uint32)
    val = rng.exponential(1.0, int(off[-1]))
    val = (val / np.sqrt(np.repeat(np.add.reduceat(val * val, off[:-1]),
                                   lens))).astype(np.float32)
    if w is None:
        w = np.zeros(n_feat)
        w[:100] = rng.normal(0, 1, 100)
    y = (np.add.reduceat(w[idx] * val, off[:-1]) > 0).astype(np.float64)
    rows = list(zip(np.split(idx, off[1:-1]), np.split(val, off[1:-1])))
    return rows, y, w


def _vw_launches_per_step(rows, steps):
    """Launches and device-busy time of ``steps`` minibatch steps of 23a's
    fit (the first minibatches, logistic, no l1/l2), by ``torch.profiler``."""
    import torch
    from mmlspark_tpu_torch.vw import learners as L
    dev = _dev23()
    B = P23["vw_batch"]
    idx, val = L.pad_sparse(rows[:steps * B])
    idx = torch.from_numpy(idx).to(dev).long().view(steps, B, -1)
    val = torch.from_numpy(val).to(dev).view(steps, B, -1)
    y = torch.ones(steps, B, device=dev)
    sw = torch.ones(steps, B, device=dev)
    w = torch.zeros(1 << P23["vw_bits"], device=dev)
    G = torch.full_like(w, 1e-12)

    def run():
        return L.train_passes(w, G, idx, val, y, sw, loss="logistic",
                              tau=0.5, n_passes=1, lr=0.5, l1=0.0, l2=0.0,
                              power_t=0.5)
    run()                                       # warm
    n, wall, busy, launches = _profiled(run)
    return {"steps": n, "launches_per_step": launches / n,
            "ms_per_step": wall * 1e3 / n,
            "device_busy_ms_per_step": None if busy is None
            else busy * 1e3 / n, **_share(wall, busy),
            "K": int(idx.shape[-1]), "B": B} if n else {}


def _featurizer_rows(n, seed):
    """Raw string and numeric columns: two categoricals, a text column of
    3-12 tokens from a 5,000-word vocabulary, a float and an int column."""
    import numpy as np
    from mmlspark_tpu_torch.core import DataFrame
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(5000)], dtype=object)
    toks = rng.integers(0, 5000, (n, 12))
    lens = rng.integers(3, 13, n)
    text = np.array([" ".join(words[toks[i, :lens[i]]]) for i in range(n)],
                    dtype=object)
    return DataFrame({
        "site": np.array([f"site{i}" for i in rng.integers(0, 1000, n)],
                         dtype=object),
        "device": np.array([f"dev{i}" for i in rng.integers(0, 50, n)],
                           dtype=object),
        "text": text,
        "price": np.round(rng.lognormal(1.0, 1.0, n), 2),
        "count": rng.integers(0, 5, n)})


def _featurizer_plain(df, rows, bits):
    """The indices of ``rows`` by the plain murmur3 loop (sum_collisions
    off: each column's features in order, zeros skipped)."""
    import numpy as np
    from mmlspark_tpu_torch.vw.murmur import _murmur3_32_py
    mask = (1 << bits) - 1
    seeds = {c: _murmur3_32_py(c.encode("utf-8"), 0) for c in df.columns}
    out = []
    for r in rows:
        idx = []
        for c in df.columns:
            v = df[c][r]
            if isinstance(v, str):
                for t in (v.split() if c == "text" else [v]):
                    idx.append(_murmur3_32_py(
                        (c + "\x1f" + t).encode("utf-8"), seeds[c]) & mask)
            elif v != 0:
                idx.append(seeds[c] & mask)
        out.append(np.asarray(idx, np.uint32))
    return out


def _bandit_events(n, k, segments, seed):
    """Logged bandit events: a shared context of one of ``segments`` user
    segments plus two noise features, ``k`` arms with one feature each;
    arm (segment % k) costs 0, the others 1 (plus noise); the logged arm is
    uniform, logged with probability 1/k."""
    import numpy as np
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.vw.featurizer import NUM_BITS_KEY, sparse_column
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, segments, n)
    noise = rng.integers(1000, 2000, (n, 2))
    shared = [(np.array([100 + seg[i], *noise[i]], np.uint32),
               np.array([1.0, 0.5, 0.5], np.float32)) for i in range(n)]
    arms = [(np.array([200 + a], np.uint32), np.ones(1, np.float32))
            for a in range(k)]
    chosen = rng.integers(0, k, n)
    cost = (chosen != seg % k).astype(np.float32) + \
        rng.normal(0, 0.05, n).astype(np.float32)
    df = DataFrame({"shared": sparse_column(shared),
                    "features": sparse_column([arms] * n),
                    "chosenAction": chosen + 1, "label": cost,
                    "probability": np.full(n, 1.0 / k, np.float32)})
    return df.with_column_metadata("features", {NUM_BITS_KEY: 18}), seg % k


def phase_vw(dev_info):
    """23a: VowpalWabbit at rcv1.binary's shape on the card."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.vw import (VowpalWabbitClassifier,
                                       VowpalWabbitContextualBandit,
                                       VowpalWabbitFeaturizer)
    from mmlspark_tpu_torch.vw.featurizer import sparse_column
    p = P23
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows, y, w = rcv1_like(p["vw_rows"], p["vw_features"], p["vw_nnz"], 23)
    held, hy, _ = rcv1_like(p["vw_held_out"], p["vw_features"], p["vw_nnz"],
                            24, w)
    data_s = time.perf_counter() - t0
    kw = dict(num_bits=p["vw_bits"], mini_batch=p["vw_batch"],
              num_passes=p["vw_passes"], loss_function="logistic")
    hdf = DataFrame({"features": sparse_column(held)})

    # the first 65,536 rows on the card and on the CPU: weights within
    # 1e-4 of the largest |weight| (float32 scatter-adds of up to 64 rows'
    # duplicates in another order each step; the steps do not amplify it)
    # and held-out AUCs within 0.002
    n0 = p["vw_parity_rows"]
    sub = DataFrame({"features": sparse_column(rows[:n0]), "label": y[:n0]})
    m_card = VowpalWabbitClassifier(**kw).fit(sub)
    t0 = time.perf_counter()
    m_cpu = VowpalWabbitClassifier(device="cpu", **kw).fit(sub)
    cpu_fit_s = time.perf_counter() - t0
    w_card, w_cpu = m_card.get("weights"), m_cpu.get("weights")
    w_err = float(np.abs(w_card - w_cpu).max())
    w_tol = 1e-4 * float(np.abs(w_cpu).max())
    sub_auc = [_auc(hy, m.transform(hdf)["rawPrediction"])
               for m in (m_card, m_cpu)]
    if not (np.isfinite(w_card).all() and w_err <= w_tol
            and abs(sub_auc[0] - sub_auc[1]) <= 0.002):
        raise AssertionError(f"23a: card weights {w_err} from the CPU's "
                             f"(bound {w_tol}), held-out AUCs {sub_auc}")

    # the whole set on the card (timed): held-out AUC at least 0.9
    df = DataFrame({"features": sparse_column(rows), "label": y})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = VowpalWabbitClassifier(**kw).fit(df)
    fit_s = time.perf_counter() - t0
    auc_card = _auc(hy, card.transform(hdf)["rawPrediction"])
    if not auc_card >= 0.9:
        raise AssertionError(f"23a: held-out AUC {auc_card}; want >= 0.9")
    steps = card.train_steps
    prof = _vw_launches_per_step(rows, p["vw_profile_steps"])
    learner = {"rows": p["vw_rows"], "K": int(max(len(r[0]) for r in rows)),
               "steps": steps, "fit_s": fit_s,
               "phase_seconds": card.phase_seconds,
               "rows_per_s": p["vw_rows"] * p["vw_passes"]
               / card.phase_seconds["train"],
               "ms_per_step": card.phase_seconds["train"] * 1e3 / steps,
               "profile": prof, "auc": auc_card,
               "parity_rows": n0, "parity_max_abs_err": w_err,
               "parity_bound": w_tol, "parity_auc": sub_auc,
               "parity_cpu_fit_s": cpu_fit_s, "data_s": data_s,
               "peak_gb": _peak_gb()}
    log(f"[23a vw] {json.dumps(learner)} | {dev_info['smi']}")

    # the featurizer over 100,000 raw rows (host work), indices bitwise the
    # plain murmur3 loop's on the first 1,000
    fdf = _featurizer_rows(p["feat_rows"], 25)
    feat = VowpalWabbitFeaturizer(input_cols=list(fdf.columns),
                                  string_split_cols=["text"],
                                  num_bits=p["vw_bits"],
                                  sum_collisions=False)
    t0 = time.perf_counter()
    out = feat.transform(fdf)["features"]
    feat_s = time.perf_counter() - t0
    nchk = p["feat_check_rows"]
    for r, want in enumerate(_featurizer_plain(fdf, range(nchk),
                                               p["vw_bits"])):
        if not np.array_equal(out[r][0], want):
            raise AssertionError(f"23a: featurizer row {r} indices differ "
                                 f"from the plain murmur3 loop")
    featurizer = {"rows": p["feat_rows"], "host_s": feat_s,
                  "rows_per_s": p["feat_rows"] / feat_s,
                  "checked_rows": nchk}
    log(f"[23a featurizer] {json.dumps(featurizer)}")

    # the contextual bandit on 65,536 events of 4 arms, fitted on the card
    # and on the CPU; the CPU model scores the first 8,192 events (the
    # crossing is host work, the same for both)
    cdf, best = _bandit_events(p["cb_events"], p["cb_actions"],
                               p["cb_segments"], 26)
    cbk = dict(num_passes=2, epsilon=0.05)
    t0 = time.perf_counter()
    cb_card = VowpalWabbitContextualBandit(**cbk).fit(cdf)
    cb_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    o_card = cb_card.transform(cdf)
    cb_pred_s = time.perf_counter() - t0
    nc = min(p["cb_cpu_events"], p["cb_events"])
    o_cpu = VowpalWabbitContextualBandit(device="cpu", **cbk).fit(
        cdf).transform(cdf.take(np.arange(nc)))
    s_card = np.stack(list(o_card["scores"][:nc]))
    s_cpu = np.stack(list(o_cpu["scores"]))
    s_err = float(np.abs(s_card - s_cpu).max())
    s_tol = 1e-4 * float(np.abs(s_cpu).max()) + 1e-6
    gap = np.sort(s_cpu, axis=1)
    clear = (gap[:, 1] - gap[:, 0]) > 2 * s_tol
    agree = float((o_card["prediction"] - 1 == best).mean())
    if not (s_err <= s_tol and np.array_equal(
            o_card["prediction"][:nc][clear], o_cpu["prediction"][clear])
            and agree > 0.9):
        raise AssertionError(f"23a: bandit scores {s_err} from the CPU's "
                             f"(bound {s_tol}), best arm found on "
                             f"{agree} of events")
    bandit = {"events": p["cb_events"], "actions": p["cb_actions"],
              "fit_s": cb_fit_s, "predict_s": cb_pred_s,
              "cpu_compared_events": nc,
              "scores_max_abs_err": s_err, "bound": s_tol,
              "best_arm_share": agree}
    log(f"[23a bandit] {json.dumps(bandit)}")
    return {"learner": learner, "featurizer": featurizer, "bandit": bandit}


def phase_knn(dev_info):
    """23b: exact KNN at SIFT1M's shape on the card."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.nn import KNN
    from mmlspark_tpu_torch.nn.knn import D2_BUDGET_BYTES, brute_force_knn
    p = P23
    dev = _dev23()
    gen = torch.Generator(device=dev).manual_seed(23)
    n, d = p["knn_corpus"], p["knn_dim"]
    centers = torch.rand(p["knn_centers"], d, generator=gen, device=dev) * 120

    def draw(m):
        a = torch.randint(0, p["knn_centers"], (m,), generator=gen,
                          device=dev)
        x = centers[a] + 15 * torch.randn(m, d, generator=gen, device=dev)
        return x.clamp_(min=0).cpu().numpy()
    X, Q = draw(n), draw(p["knn_queries"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = KNN(k=p["knn_k"]).fit(DataFrame({"features": X}))
    fit_s = time.perf_counter() - t0
    qdf = DataFrame({"features": Q})
    model.transform(DataFrame({"features": Q[:8]}))     # places the corpus
    out, wall, busy, launches = _profiled(
        lambda: model.transform(qdf)["output"])
    peak = _peak_gb()
    corpus = model._device_corpus()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, dist = brute_force_knn(corpus, Q, p["knn_k"])
    search_s = time.perf_counter() - t0

    # 256 queries against a float64 brute force: each returned id's true
    # squared distance at most the true k-th's plus 1e-5 (||q||^2 + max
    # ||c||^2) (float32 rounding of the three-term sum), recall@100 >= 0.999
    m = p["knn_check"]
    C64 = corpus.double()
    q64 = torch.from_numpy(Q[:m]).to(dev).double()
    d2 = (q64 * q64).sum(1)[:, None] + (C64 * C64).sum(1)[None, :] \
        - 2.0 * q64 @ C64.T
    kth = d2.kthvalue(p["knn_k"], dim=1).values
    ids = torch.from_numpy(idx[:m]).to(dev)
    got = d2.gather(1, ids)
    tol = 1e-5 * ((q64 * q64).sum(1) + (C64 * C64).sum(1).max())
    over = float((got - kth[:, None] - tol[:, None]).max())
    true_top = torch.topk(-d2, p["knn_k"], dim=1).indices
    recall = float(np.mean([len(set(a) & set(b)) / p["knn_k"] for a, b in
                            zip(ids.cpu().tolist(), true_top.cpu().tolist())]))
    del C64, d2
    served = [[r["value"] for r in row] for row in out[:m]]
    if not (over <= 0 and recall >= 0.999 and served == idx[:m].tolist()
            and np.isfinite(dist).all()):
        raise AssertionError(f"23b: {over} past the k-th distance bound, "
                             f"recall@{p['knn_k']} {recall}")
    rec = {"corpus": n, "dim": d, "queries": p["knn_queries"],
           "k": p["knn_k"], "fit_s": fit_s,
           "transform": {**_share(wall, busy), "launches": launches,
                         "queries_per_s": p["knn_queries"] / wall},
           "search_s": search_s,
           "search_queries_per_s": p["knn_queries"] / search_s,
           "chunk_queries": max(1, D2_BUDGET_BYTES // (4 * n)),
           "peak_gb": peak, "recall_at_k": recall,
           "worst_over_bound": over, "checked_queries": m}
    torch.cuda.empty_cache()
    log(f"[23b knn] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def movielens_like(n_users, n_items, n_ratings, seed):
    """``n_ratings`` distinct (user, item) ratings 1-5 with timestamps over
    three years from ``seed``: lognormal user activity, Zipf-like item
    popularity (MovieLens-1M's shape)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pu = rng.lognormal(0.0, 1.0, n_users)
    pi = 1.0 / np.arange(1, n_items + 1) ** 0.9
    pi = pi[rng.permutation(n_items)]
    m = int(n_ratings * 1.6)
    u = rng.choice(n_users, m, p=pu / pu.sum())
    i = rng.choice(n_items, m, p=pi / pi.sum())
    _, first = np.unique(u * n_items + i, return_index=True)
    if len(first) < n_ratings:
        raise AssertionError("movielens_like: too few distinct pairs")
    keep = np.sort(first)[:n_ratings]
    return {"user": u[keep], "item": i[keep],
            "rating": rng.integers(1, 6, n_ratings).astype(np.float64),
            "timestamp": 956_703_932 + rng.uniform(0, 3 * 365 * 86400,
                                                   n_ratings)}


def phase_sar(dev_info):
    """23c: SAR at MovieLens-1M's shape on the card."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.recommendation import SAR
    p = P23
    dev = _dev23()
    cols = movielens_like(p["sar_users"], p["sar_items"], p["sar_ratings"],
                          23)
    kw = dict(similarity_function="jaccard", time_col="timestamp",
              time_decay_coeff=30, support_threshold=4)
    torch.cuda.reset_peak_memory_stats()
    model, wall, busy, launches = _profiled(
        lambda: SAR(**kw).fit(DataFrame(dict(cols))))
    t0 = time.perf_counter()
    cpu = SAR(device="cpu", **kw).fit(DataFrame(dict(cols)))
    cpu_fit_s = time.perf_counter() - t0
    S = model.get("item_similarity")
    if not np.array_equal(S, cpu.get("item_similarity")):
        raise AssertionError("23c: the card's item similarity is not "
                             "bitwise the CPU's (exact co-occurrence "
                             "counts)")
    # scores at 100,000 pairs against a float64 product: within 1e-4 of the
    # float64 score + 1e-6 (a sum of 3,706 non-negative float32 terms;
    # n * eps = 2.2e-4 is its worst case)
    rng = np.random.default_rng(27)
    pairs = {"user": rng.integers(0, p["sar_users"], p["sar_pairs"]),
             "item": rng.integers(0, p["sar_items"], p["sar_pairs"])}
    t0 = time.perf_counter()
    got = model.transform(DataFrame(dict(pairs)))["prediction"]
    score_s = time.perf_counter() - t0
    A64 = torch.from_numpy(model.get("user_affinity")).to(dev).double()
    S64 = torch.from_numpy(S).to(dev).double()
    ref = (A64 @ S64)[torch.from_numpy(pairs["user"]).to(dev),
                      torch.from_numpy(pairs["item"]).to(dev)].cpu().numpy()
    err = np.abs(got - ref) - (1e-4 * np.abs(ref) + 1e-6)
    t0 = time.perf_counter()
    recs = model.recommend_for_all_users(k=10)
    rec_s = time.perf_counter() - t0
    A = model.get("user_affinity")
    lists = list(recs["recommendations"])
    if not (float(err.max()) <= 0 and len(lists) == p["sar_users"]
            and all(len(r) <= 10 and all(A[u, i] == 0 for i in r)
                    for u, r in enumerate(lists))):
        raise AssertionError(f"23c: scores {float(err.max())} past the "
                             f"bound, or seen items recommended")
    rec = {"users": p["sar_users"], "items": p["sar_items"],
           "ratings": p["sar_ratings"],
           "fit": {**_share(wall, busy), "launches": launches},
           "cpu_fit_s": cpu_fit_s, "score_pairs_s": score_s,
           "recommend_all_k10_s": rec_s, "peak_gb": _peak_gb(),
           "similarity_nonzero": int((S > 0).sum()),
           "scores_worst_over_bound": float(err.max())}
    log(f"[23c sar] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def access_logs(tenants, n_users, n_res, n_acc, depts, bridges, seed):
    """Access logs clustered by department, as ``cyber/dataset.py``'s
    generator clusters them: each user and resource belongs to one of
    ``depts`` departments and accesses stay inside it, but for
    ``bridges`` cross-department accesses a tenant (one connected
    component). Returns (columns, {tenant: (user dept, res dept)})."""
    import numpy as np
    from mmlspark_tpu_torch.core.dataframe import object_col
    rng = np.random.default_rng(seed)
    cols = {"tenant": [], "user": [], "res": [], "likelihood": []}
    depts_of = {}
    for t in range(tenants):
        ud = rng.integers(0, depts, n_users)
        rd = rng.integers(0, depts, n_res)
        order = np.argsort(rd, kind="stable")
        counts = np.bincount(rd, minlength=depts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        u = rng.integers(0, n_users, n_acc)
        pick = (rng.random(n_acc) * counts[ud[u]]).astype(np.int64)
        r = order[starts[ud[u]] + pick]
        bu = rng.integers(0, n_users, bridges)
        u[:bridges] = bu
        r[:bridges] = order[starts[(ud[bu] + 1) % depts]
                            + rng.integers(0, counts[(ud[bu] + 1) % depts])]
        cols["tenant"] += [f"tenant{t}"] * n_acc
        cols["user"] += [f"u{x}" for x in u]
        cols["res"] += [f"r{x}" for x in r]
        cols["likelihood"].append(rng.integers(1, 10, n_acc).astype(float))
        depts_of[f"tenant{t}"] = (ud, rd)
    return ({"tenant": object_col(cols["tenant"]),
             "user": object_col(cols["user"]),
             "res": object_col(cols["res"]),
             "likelihood": np.concatenate(cols["likelihood"])}, depts_of)


def phase_access_anomaly(dev_info):
    """23d: AccessAnomaly's ALS on the card, two tenants."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.core.dataframe import object_col
    from mmlspark_tpu_torch.cyber import AccessAnomaly
    p = P23
    cols, depts = access_logs(p["aa_tenants"], p["aa_users"], p["aa_res"],
                              p["aa_accesses"], p["aa_depts"],
                              p["aa_bridges"], 23)
    kw = dict(rank_param=p["aa_rank"], max_iter=p["aa_iters"], seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = AccessAnomaly(**kw).fit(DataFrame(dict(cols)))
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = AccessAnomaly(device="cpu", **kw).fit(DataFrame(dict(cols)))
    cpu_fit_s = time.perf_counter() - t0
    # 10,000 test pairs: half seen (scored without the history rule), half
    # across departments and unseen
    rng = np.random.default_rng(28)
    half = p["aa_test"] // 2
    seen_rows = rng.choice(len(cols["user"]), half, replace=False)
    tenant = rng.integers(0, p["aa_tenants"], half)
    cu, cr = [], []
    for t in range(p["aa_tenants"]):
        ud, rd = depts[f"tenant{t}"]
        k = int((tenant == t).sum())
        u = rng.integers(0, p["aa_users"], 4 * k)
        r = rng.integers(0, p["aa_res"], 4 * k)
        far = np.flatnonzero(ud[u] != rd[r])[:k]
        cu += [f"u{x}" for x in u[far]]
        cr += [f"r{x}" for x in r[far]]
    test = DataFrame({
        "tenant": object_col(list(cols["tenant"][seen_rows])
                             + [f"tenant{t}" for t in sorted(tenant)]),
        "user": object_col(list(cols["user"][seen_rows]) + cu),
        "res": object_col(list(cols["res"][seen_rows]) + cr)})
    scores = []
    for m in (model, cpu):
        m.set(preserve_history=False)
        s = m.transform(test)["anomaly_score"]
        scores.append(np.array([np.nan if v is None else v for v in s]))
    card, ref = scores
    fin = np.isfinite(ref)
    # z-scores from factors solved through cuBLAS / cuSOLVER and through the
    # CPU's BLAS / LAPACK (sums of 2,000 or 10,000 float32 terms, 25
    # alternating ridge solves): within 1e-3 (1 + max |score|)
    tol = 1e-3 * (1.0 + float(np.abs(ref[fin]).max()))
    err = float(np.abs(card[fin] - ref[fin]).max())
    seen_mean = float(np.nanmean(card[:half]))
    cross = card[half:]
    cross_mean = float(np.mean(cross[np.isfinite(cross)]))
    if not (np.array_equal(np.isfinite(card), fin) and fin.mean() > 0.99
            and err <= tol and seen_mean < cross_mean):
        raise AssertionError(f"23d: scores {err} from the CPU's (bound "
                             f"{tol}); seen mean {seen_mean}, cross-"
                             f"department mean {cross_mean}")
    als_iters = p["aa_iters"] * p["aa_tenants"]
    rec = {"tenants": p["aa_tenants"], "users": p["aa_users"],
           "resources": p["aa_res"], "accesses": p["aa_accesses"],
           "rank": p["aa_rank"], "iters": p["aa_iters"], "fit_s": fit_s,
           "phase_seconds": model.phase_seconds,
           "als_s_per_iter": model.phase_seconds["als"] / als_iters,
           "cpu_fit_s": cpu_fit_s, "cpu_phase_seconds": cpu.phase_seconds,
           "host_share": model.phase_seconds["host"] / fit_s,
           "scores_max_abs_err": err, "bound": tol,
           "seen_mean": seen_mean, "cross_mean": cross_mean,
           "peak_gb": _peak_gb()}
    log(f"[23d access anomaly] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


class _ProbeRunner:
    """A measured-sweep probe: the frame through a copy of ``model`` set to
    one candidate config (``run_and_drain`` is all ``measured_sweep``
    calls)."""

    def __init__(self, model, df, m, d, ladder):
        self.model = model.copy({"mini_batch_size": m, "prefetch_depth": d,
                                 "buckets": list(ladder or []),
                                 "tuning": ""})
        self.df = df

    def run_and_drain(self, n_rows):
        return self.model.transform(self.df)


def phase_tuning(dev_info):
    """23e: ``tuning="auto"`` on phase 11's ResNet-50 through ONNXModel."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.tuning import (ObservationStore, measured_sweep,
                                           probe_budget, resolve_tuning,
                                           set_store)
    from mmlspark_tpu_torch.tuning.cost_model import M_PROBES
    p = P23
    model_bytes, _ = _resnet50_onnx()
    parts = list(p["tune_parts"])
    X = np.random.default_rng(29).integers(0, 256, (sum(parts), 224, 224, 3),
                                           dtype=np.uint8)
    df = DataFrame({"image": X}, partition_sizes=parts)
    hist = {n: 1 for n in parts}
    d = tempfile.mkdtemp(prefix="tuning23_")
    torch.cuda.reset_peak_memory_stats()
    batch = p["tune_batch"]
    try:
        base = _onnx_model(model_bytes, "bfloat16", batch)
        set_store(ObservationStore(d))
        base.transform(df)                      # warm: cuDNN, the params
        t0 = time.perf_counter()
        plain = base.transform(df)["logits"]
        plain_s = time.perf_counter() - t0
        # cold: a fresh store in a temporary directory
        store = ObservationStore(d + "/store")
        set_store(store)
        cold = _onnx_model(model_bytes, "bfloat16", batch, tuning="auto")
        sig = cold.tuning_signature()
        if resolve_tuning(sig, "default", hist, store=store) is not None:
            raise AssertionError("23e: the fresh store is not cold")
        before = M_PROBES.labels().get()
        t0 = time.perf_counter()
        decision = measured_sweep(
            lambda m, dd, ladder: _ProbeRunner(cold, df, m, dd, ladder),
            sum(parts), sig=sig, histogram=hist, store=store,
            defaults=(batch, 2))
        sweep_s = time.perf_counter() - t0
        probes = M_PROBES.labels().get() - before
        t0 = time.perf_counter()
        cold_out = cold.transform(df)["logits"]
        cold_s = time.perf_counter() - t0
        rows_written = len(store)
        # warm: a second model on the store as persisted, no probe
        warm_store = ObservationStore(d + "/store")
        set_store(warm_store)
        warm = _onnx_model(model_bytes, "bfloat16", batch, tuning="auto")
        picks = {n: warm._resolve_tuning({n: 1}) for n in parts}
        before = M_PROBES.labels().get()
        t0 = time.perf_counter()
        warm_out = warm.transform(df)["logits"]
        warm_s = time.perf_counter() - t0
        _, wall, busy, launches = _profiled(
            lambda: warm.transform(df)["logits"])
        warm_probes = M_PROBES.labels().get() - before
    finally:
        set_store(None)
        shutil.rmtree(d, ignore_errors=True)
    # phase 11's bf16 bound: 2^-4 of the largest |logit|
    bound = 2.0 ** -4 * float(np.abs(plain).max())
    errs = [float(np.abs(o - plain).max()) for o in (cold_out, warm_out)]
    if not (0 < probes <= probe_budget() and rows_written >= probes
            and warm_probes == 0 and all(v is not None
                                         for v in picks.values())
            and max(errs) <= bound and np.isfinite(warm_out).all()):
        raise AssertionError(f"23e: {probes} probes (budget "
                             f"{probe_budget()}), warm probes {warm_probes}, "
                             f"decisions {picks}, errors {errs} (bound "
                             f"{bound})")
    n = sum(parts)
    rec = {"partitions": parts, "probes": int(probes),
           "budget": probe_budget(),
           "sweep_s": sweep_s, "store_rows": rows_written,
           "decision": decision.as_dict(), "fit": decision.details,
           "warm_decisions": {str(k): v.as_dict() for k, v in picks.items()},
           "images_per_s": {"untuned": n / plain_s, "cold_call": n / cold_s,
                            "cold_with_sweep": n / (sweep_s + cold_s),
                            "warm_call": n / warm_s},
           "warm_profile": {**_share(wall, busy), "launches": launches},
           "max_abs_vs_untuned": errs, "bound": bound,
           "peak_gb": _peak_gb()}
    log(f"[23e tuning] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


#: phase 24: the AutoML training pipeline over the ported learners
P24 = dict(
    # 24a: UCI Adult's adult.data shape (32,561 rows; 6 numeric and 8
    # string columns, the strings' level counts with "?" counted as a
    # level; 24.08% ">50K"). The numeric columns are drawn standardized:
    # the default LogisticRegression (full-batch Adam at lr 0.1, as in the
    # JAX package) does not scale its inputs
    adult_rows=32_561, adult_pos=0.2408, adult_test=0.25,
    adult_levels=(("workclass", 9), ("education", 16),
                  ("marital-status", 7), ("occupation", 15),
                  ("relationship", 6), ("race", 5), ("sex", 2),
                  ("native-country", 42)),
    # LightGBM at 10 iterations of learning rate 0.3: the CPU's fit of
    # the same model costs ~0.9 s an iteration at this width
    adult_iters=10, adult_lr=0.3, lr_auc_floor=0.8, gbdt_auc_floor=0.8,
    # K6 adds a slot's g and h with float32 atomics in an order that
    # changes from run to run, the CPU's plain version with index_add_
    # (2.04e-6 against 1.7e-4 of a slot, PERF.md §6), so a near-tied gain
    # (the one-hot columns tie often) picks another split and the two
    # models may part after a few trees (mean |dp| 0.017 in one run, 1.5e-7
    # in the next, at 30 iterations): the card's LightGBM AUC is held within
    # 5e-3 of the CPU's on the 8,140 test rows (they differed by 1.1e-3 and
    # by 0), the floor below catching a model that learns nothing
    gbdt_auc_tol=5e-3, lr_auc_tol=1e-4,
    # a logistic-regression prediction may flip only where the CPU's
    # probability is this close to 1/2 (float32 sums in another order)
    lr_margin=1e-4,
    # 24b: the first 250,000 rows of phase 8's HIGGS-shaped set (1,000,000
    # until phase 25 joined the script, 500,000 until phase 26 did, to
    # keep it within its time limit), 28 features; 8 trials a search; full and tpe at 16
    # iterations a trial; a tenth of the rows validates (a trial's host
    # statistics cost ~1 s per 200,000 rows)
    higgs_rows=250_000, trials=8, trial_iters=16, tpe_startup=4,
    train_fraction=0.9,
    halving=(4, 64, 4), higgs_auc_floor=0.75,
    # 24c: generated book reviews, 20-200 tokens over a Zipf vocabulary of
    # 50,000 words, ratings 1-5 thresholded at 3
    reviews=20_000, vocab=50_000, tokens=(20, 200), zipf=1.07,
    # the logistic regression takes an L2 penalty, as the notebook's does
    text_features=1 << 12, text_reg=0.01, text_check_rows=1_000,
    text_auc_floor=0.8)


def adult_like(n, seed=24):
    """An Adult-shaped frame's columns: the six numeric columns, the
    eight string columns at Adult's level counts, and ``income`` drawn
    from a fixed logistic function of them (logistic noise, cut at the
    share of ">50K")."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cols, z = {}, np.zeros(n)
    for name in ("age", "fnlwgt", "education-num", "capital-gain",
                 "capital-loss", "hours-per-week"):
        cols[name] = rng.normal(0, 1, n)
        z += rng.normal(0, 0.6) * cols[name] if name != "fnlwgt" else 0.0
    for name, k in P24["adult_levels"]:
        levels = np.array([f"{name}-{i}" for i in range(k - 1)] + ["?"],
                          dtype=object)
        p = rng.dirichlet(np.full(k, 0.7))
        idx = rng.choice(k, n, p=p)
        cols[name] = levels[idx]
        z += rng.normal(0, 0.8, k)[idx]
    s = z + rng.logistic(0, 1, n)
    cut = np.quantile(s, 1 - P24["adult_pos"])
    cols["income"] = np.where(s > cut, ">50K", "<=50K").astype(object)
    return cols


def _split(df, frac, seed):
    import numpy as np
    sh = df.shuffle(seed)
    n_test = int(round(frac * len(df)))
    return (sh.take(np.arange(n_test, len(df))), sh.take(np.arange(n_test)))


def _stats(model, test, label):
    """(AUC, accuracy, scored frame, stats and per-row seconds) of a
    trained wrapper on ``test``."""
    from mmlspark_tpu_torch.train import (ComputeModelStatistics,
                                          ComputePerInstanceStatistics)
    t0 = time.perf_counter()
    scored = model.transform(test)
    score_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = ComputeModelStatistics(label_col=label).transform(scored)
    per = ComputePerInstanceStatistics(label_col=label).transform(scored)
    stats_s = time.perf_counter() - t0
    import numpy as np
    if not np.isfinite(per["log_loss"]).all():
        raise AssertionError("24: non-finite per-row log loss")
    return (float(st["AUC"][0]), float(st["accuracy"][0]), scored,
            {"score_s": score_s, "statistics_s": stats_s,
             "mean_log_loss": float(np.mean(per["log_loss"]))})


def _k6_counts(what):
    """K6 launches since :func:`_zero_launch_counts`; none may be plain."""
    k6, plain, _native, _numpy = _launch_counts()
    if k6 == 0 or plain:
        raise AssertionError(f"{what}: K6 launches {k6} (want > 0), plain "
                             f"calls {plain} (want 0)")
    return k6


def phase_train_adult(dev_info):
    """24a: ``TrainClassifier`` on an Adult-shaped frame, the default
    LogisticRegression and LightGBMClassifier (K6), each scored by
    ComputeModelStatistics / ComputePerInstanceStatistics, against the
    same port code with ``device="cpu"``."""
    import numpy as np
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.featurize import Featurize
    from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.train import TrainClassifier
    p = P24
    df = DataFrame(adult_like(p["adult_rows"]))
    train, test = _split(df, p["adult_test"], 24)
    # Featurize's host seconds alone (TrainClassifier runs it again)
    t0 = time.perf_counter()
    fm = Featurize([c for c in df.columns if c != "income"]).fit(train)
    width = len(fm.transform(train)["features"][0])
    featurize_s = time.perf_counter() - t0
    rec = {"rows": p["adult_rows"], "train_rows": len(train),
           "feature_width": width, "featurize_host_s": featurize_s}
    runs, bad = {}, []
    for name, make in (
            ("logistic", lambda dev: TrainClassifier(label_col="income",
                                                     device=dev)),
            ("lightgbm", lambda dev: TrainClassifier(
                model=LightGBMClassifier(device=dev,
                                         num_iterations=p["adult_iters"],
                                         learning_rate=p["adult_lr"]),
                label_col="income"))):
        out = {}
        for dev in (None, "cpu"):
            _zero_launch_counts()
            t0 = time.perf_counter()
            model = make(dev).fit(train)
            fit_s = time.perf_counter() - t0
            k6 = _launch_counts()[0] if dev is None else None
            if dev is None and name == "lightgbm":
                k6 = _k6_counts("24a lightgbm")
            auc, acc, scored, st = _stats(model, test, "income")
            out["card" if dev is None else "cpu"] = dict(
                fit_s=fit_s, auc=auc, accuracy=acc, k6_launches=k6, **st,
                prob=np.stack(list(scored["probability"]))[:, 1],
                pred=np.asarray(scored["prediction"]))
        card, cpu = out["card"], out["cpu"]
        d_auc = abs(card["auc"] - cpu["auc"])
        dp = np.abs(card["prob"] - cpu["prob"])
        flips = card["pred"] != cpu["pred"]
        near = np.abs(cpu["prob"] - 0.5) <= p["lr_margin"]
        if name == "logistic":
            if d_auc > p["lr_auc_tol"] or (flips & ~near).any() or \
                    card["k6_launches"]:
                bad.append(
                    f"24a logistic: AUC {card['auc']} vs CPU {cpu['auc']} "
                    f"(bound {p['lr_auc_tol']}), {int(flips.sum())} "
                    f"predictions differ ({int((flips & ~near).sum())} away "
                    f"from 1/2), K6 launches {card['k6_launches']} (want 0)")
            floor = p["lr_auc_floor"]
        else:
            if d_auc > p["gbdt_auc_tol"]:
                bad.append(f"24a lightgbm: AUC {card['auc']} vs CPU "
                           f"{cpu['auc']} (bound {p['gbdt_auc_tol']})")
            floor = p["gbdt_auc_floor"]
        if min(card["auc"], cpu["auc"]) <= floor:
            bad.append(f"24a {name}: AUC {card['auc']} / CPU {cpu['auc']} "
                       f"at or under {floor}")
        for side in (card, cpu):
            side.pop("prob")
            side.pop("pred")
        runs[name] = {"card": card, "cpu": cpu, "auc_diff": d_auc,
                      "mean_abs_dp": float(dp.mean()),
                      "max_abs_dp": float(dp.max()),
                      "predictions_differ": int(flips.sum())}
    rec.update(runs)
    rec["k6_launches"] = runs["lightgbm"]["card"]["k6_launches"]
    log(f"[24a train adult] {json.dumps(rec)} | {dev_info['smi']}")
    if bad:
        raise AssertionError("; ".join(bad))
    return rec


def _tune(strategy, par, train_df, p, **kw):
    """One ``TuneHyperparameters`` search over LightGBMClassifier on the
    card: (tuner, best model, record)."""
    from mmlspark_tpu_torch.automl import (RandomSpace, RangeHyperParam,
                                           TuneHyperparameters)
    from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier
    space = RandomSpace(
        {"num_leaves": RangeHyperParam(15, 63, is_int=True),
         "learning_rate": RangeHyperParam(0.05, 0.3, is_log=True),
         "min_data_in_leaf": RangeHyperParam(20, 200, is_int=True),
         "feature_fraction": RangeHyperParam(0.5, 1.0)}, seed=24)
    tuner = TuneHyperparameters(
        model=LightGBMClassifier(num_iterations=p["trial_iters"]),
        search_space=space, number_of_iterations=p["trials"],
        evaluation_metric="AUC", parallelism=par, seed=24,
        train_fraction=p["train_fraction"],
        search_strategy=strategy, **kw)
    _zero_launch_counts()
    t0 = time.perf_counter()
    best = tuner.fit(train_df)
    wall = time.perf_counter() - t0
    k6 = _k6_counts(f"24b {strategy} x{par}")
    fits = {"full": p["trials"], "tpe": p["trials"]}.get(strategy)
    if strategy == "halving":
        lo, hi, eta = p["halving"]
        fits, n, r = 0, p["trials"], lo
        while r < hi and n > 1:
            fits, n, r = fits + n, max(1, n // eta), min(hi, r * eta)
        fits += n
    rec = {"strategy": strategy, "parallelism": par, "trials": fits,
           "wall_s": wall, "trials_per_s": fits / wall,
           "s_per_trial": wall / fits, "k6_launches": k6,
           "k6_per_trial": k6 / fits, "best_auc": tuner.best_metric,
           "best_params": tuner.best_params}
    return tuner, best, rec


def phase_tune_higgs(dev_info):
    """24b: TuneHyperparameters over LightGBMClassifier at HIGGS's width:
    full at parallelism 4 and 1, halving, tpe; FindBestModel over the
    three best models on the tuners' own validation rows."""
    import numpy as np
    from mmlspark_tpu_torch.automl import FindBestModel
    from mmlspark_tpu_torch.core import DataFrame
    p = P24
    t0 = time.perf_counter()
    X, y = make_higgs_like(GBDT["rows"], GBDT["features"])
    X, y = X[:p["higgs_rows"]].copy(), y[:p["higgs_rows"]].copy()
    data_s = time.perf_counter() - t0
    df = DataFrame({"features": X, "label": y})
    recs, best = {}, {}
    for key, strategy, par, kw in (
            ("full x4", "full", 4, {}), ("full x1", "full", 1, {}),
            ("halving", "halving", 4, dict(
                min_resource=p["halving"][0], max_resource=p["halving"][1],
                halving_factor=p["halving"][2])),
            ("tpe", "tpe", 4, dict(tpe_startup_trials=p["tpe_startup"]))):
        tuner, model, recs[key] = _tune(strategy, par, df, p, **kw)
        best[key] = model
        log(f"[24b {key}] {json.dumps(recs[key])}")
    log(f"[24b searches] {json.dumps(recs)} | {dev_info['smi']}")
    a, b = recs["full x4"], recs["full x1"]
    if a["best_params"] != b["best_params"] or \
            abs(a["best_auc"] - b["best_auc"]) > p["gbdt_auc_tol"]:
        raise AssertionError(f"24b: full search at parallelism 4 picked "
                             f"{a['best_params']} ({a['best_auc']}), at 1 "
                             f"{b['best_params']} ({b['best_auc']})")
    for key, r in recs.items():
        if r["best_auc"] <= p["higgs_auc_floor"]:
            raise AssertionError(f"24b {key}: best AUC {r['best_auc']} at "
                                 f"or under {p['higgs_auc_floor']}")
    # the tuners' validation rows: the same shuffle and cut
    n_train = int(round(p["train_fraction"] * len(df)))
    valid = df.shuffle(24).take(np.arange(n_train, len(df)))
    names = ["full x4", "halving", "tpe"]
    t0 = time.perf_counter()
    res = FindBestModel([best[k] for k in names],
                        evaluation_metric="AUC").fit(valid)
    find_s = time.perf_counter() - t0
    metrics = [m for _i, m in res.get("all_model_metrics")]
    pick = names[int(np.argmax(metrics))]
    if res.get("best_model") is not best[pick] or any(
            abs(m - recs[k]["best_auc"]) > 1e-12
            for k, m in zip(names, metrics)):
        raise AssertionError(f"24b FindBestModel: metrics {metrics} against "
                             f"the tuners' {[recs[k]['best_auc'] for k in names]}"
                             f", picked another model than {pick}")
    out = {"rows": len(df), "features": X.shape[1], "data_s": data_s,
           "searches": recs, "find_best": {"metrics": dict(zip(names,
                                                                metrics)),
                                           "picked": pick, "s": find_s},
           "k6_launches": sum(r["k6_launches"] for r in recs.values())}
    log(f"[24b tune higgs] {json.dumps({k: v for k, v in out.items() if k != 'searches'})} | {dev_info['smi']}")
    return out


def _syllable_words(n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    syl = np.array([c + v for c in "bcdfghjklmnprstvwz" for v in "aeiou"]
                   + ["th", "sh", "er", "an", "on", "in", "st", "ng"])
    words, seen = [], set()
    while len(words) < n:
        w = "".join(syl[rng.integers(0, len(syl), rng.integers(1, 4))])
        if w not in seen:
            seen.add(w)
            words.append(w)
    return np.array(words, dtype=object)


def reviews_like(n, seed=24):
    """Book-review-shaped text: each review 20-200 tokens drawn from a
    Zipf vocabulary, a 1-5 rating from the sentiment of its words plus
    noise (the rating shares of a review corpus), ``label`` = rating > 3."""
    import numpy as np
    p = P24
    rng = np.random.default_rng(seed)
    words = _syllable_words(p["vocab"], seed)
    prob = 1.0 / np.arange(1, p["vocab"] + 1) ** p["zipf"]
    prob /= prob.sum()
    # 500 sentiment-bearing words among ranks 20-2,000 (a review's
    # "great", "boring": common words)
    sentiment = np.zeros(p["vocab"])
    cue = rng.choice(np.arange(20, 2_000), 500, replace=False)
    sentiment[cue] = rng.normal(0, 1, 500)
    lens = rng.integers(p["tokens"][0], p["tokens"][1] + 1, n)
    ids = rng.choice(p["vocab"], int(lens.sum()), p=prob)
    starts = np.concatenate([[0], np.cumsum(lens)])
    text = np.empty(n, dtype=object)
    score = np.empty(n)
    for i in range(n):
        seg = ids[starts[i]:starts[i + 1]]
        text[i] = " ".join(words[seg])
        hits = sentiment[seg]
        score[i] = hits.sum() / np.sqrt(max(1, np.count_nonzero(hits)))
    score += rng.normal(0, 0.3, n)
    rating = 1 + np.searchsorted(np.quantile(score, [0.08, 0.17, 0.32, 0.55]),
                                 score)
    return {"text": text, "rating": rating,
            "label": (rating > 3).astype(np.int64)}


def phase_text_pipeline(dev_info):
    """24c: TextFeaturizer -> TrainClassifier(LogisticRegression) on
    20,000 generated reviews; the card's fit against the CPU's on the same
    features."""
    import numpy as np
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.featurize import TextFeaturizer
    from mmlspark_tpu_torch.models.linear import LogisticRegression
    from mmlspark_tpu_torch.train import TrainClassifier
    p = P24
    t0 = time.perf_counter()
    cols = reviews_like(p["reviews"])
    data_s = time.perf_counter() - t0
    df = DataFrame({"text": cols["text"], "label": cols["label"]})
    train, test = _split(df, 0.25, 24)
    t0 = time.perf_counter()
    tfm = TextFeaturizer(input_col="text", output_col="features",
                         num_features=p["text_features"]).fit(train)
    fit_text_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ftrain = tfm.transform(train).select(["features", "label"])
    ftest = tfm.transform(test).select(["features", "label"])
    text_s = time.perf_counter() - t0
    k = p["text_check_rows"]
    head = tfm.transform(train.head(k))["features"]
    if not all(np.array_equal(a, b) for a, b in zip(head,
                                                    ftrain["features"][:k])):
        raise AssertionError("24c: features of the first rows differ "
                             "between two transforms")
    out = {}
    for dev in (None, "cpu"):
        _zero_launch_counts()
        t0 = time.perf_counter()
        model = TrainClassifier(model=LogisticRegression(
            device=dev, reg_param=p["text_reg"]),
                                label_col="label").fit(ftrain)
        fit_s = time.perf_counter() - t0
        auc, acc, _scored, st = _stats(model, ftest, "label")
        feats = model.get("featurizer").transform(
            ftest.head(k))["features"]
        out["card" if dev is None else "cpu"] = dict(
            fit_s=fit_s, auc=auc, accuracy=acc, **st,
            k6_launches=_launch_counts()[0], features=feats)
    card, cpu = out["card"], out["cpu"]
    same = all(np.array_equal(a, b) for a, b in zip(card.pop("features"),
                                                    cpu.pop("features")))
    d_auc = abs(card["auc"] - cpu["auc"])
    tokens = int(sum(len(t.split()) for t in cols["text"]))
    rec = {"reviews": p["reviews"], "tokens": tokens, "data_s": data_s,
           "text_featurizer_fit_host_s": fit_text_s,
           "text_featurizer_transform_host_s": text_s,
           "tokens_per_host_s": tokens / (fit_text_s + text_s),
           "positive_share": float(np.mean(cols["label"])),
           "card": card, "cpu": cpu, "auc_diff": d_auc}
    log(f"[24c text] {json.dumps(rec)} | {dev_info['smi']}")
    if not same or d_auc > p["lr_auc_tol"] or \
            min(card["auc"], cpu["auc"]) <= p["text_auc_floor"]:
        raise AssertionError(f"24c: features bitwise {same}; AUC "
                             f"{card['auc']} vs CPU {cpu['auc']} (within "
                             f"{p['lr_auc_tol']}, above "
                             f"{p['text_auc_floor']})")
    return rec


#: phase 25: HTTP on the port's own server (25a, phase 5's FULL model in
#: f32 at phase 5's engine settings), the local anomaly detector at the
#: Numenta Anomaly Benchmark's week of 5-minute points (25b), and the
#: standard-library transport against an in-process mock (25c)
P25 = dict(slots=16, max_len=1024, page_size=16, prefill_chunk=256,
           steps_per_dispatch=4, sizes=(32, 128, 384), max_new=64,
           async_rows=64, single_rows=4, concurrency=16,
           series=1000, points=2016, sentiment_rows=5_000,
           shed_rows=250)


def _served_codes():
    """The port server's answered requests by status code so far."""
    from mmlspark_tpu_torch.serving import server as srv
    out = {}
    for labels, series in srv._M_REQUESTS.series():
        out[labels["code"]] = out.get(labels["code"], 0) + int(series.get())
    return out


def _timed_handler(times):
    """``advanced_handler`` with each request's client seconds kept."""
    from mmlspark_tpu_torch.io.http.clients import advanced_handler
    inner = advanced_handler(timeout=600.0)
    lock = threading.Lock()

    def handle(session, request):
        t0 = time.perf_counter()
        try:
            return inner(session, request)
        finally:
            with lock:
                times.append(time.perf_counter() - t0)
    return handle


def _http_rows(df_cls, obj, rows, concurrency, url, times):
    from mmlspark_tpu_torch.io.http import (JSONInputParser,
                                            SimpleHTTPTransformer)
    t = SimpleHTTPTransformer(input_col="req", output_col="reply",
                              error_col="error", concurrency=concurrency,
                              timeout=600.0,
                              input_parser=JSONInputParser(url=url),
                              handler=_timed_handler(times))
    return t.transform(df_cls({"req": obj(rows)}))


def phase_http_generation(params_np, dev_info):
    """25a: the port's HTTP client layer in front of the port's own
    generation server, f32 at full width; each row's tokens against an
    in-process ``ContinuousDecoder`` with the same settings."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.core.dataframe import object_col
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    from mmlspark_tpu_torch.serving.generation import GenerationEngine
    c = P25
    cfg = _full_cfg(torch.float32)
    rng = np.random.default_rng(25)
    n_rows = c["async_rows"] + c["single_rows"]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab,
                                             c["sizes"][i % 3])]
               for i in range(n_rows)]
    rows = [{"tokens": p, "max_new": c["max_new"]} for p in prompts]
    settings = dict(max_slots=c["slots"], max_len=c["max_len"],
                    page_size=c["page_size"],
                    prefill_chunk=c["prefill_chunk"],
                    steps_per_dispatch=c["steps_per_dispatch"])
    eng = GenerationEngine(params_np, cfg, transport="threaded", **settings)
    times = {"async": [], "single": []}
    try:
        eng.start()
        st, _ = _post(eng.address, {"tokens": [1, 2, 3], "max_new": 4})
        assert st == 200
        dec = eng.decoder
        torch.cuda.synchronize()
        stats0 = dict(dec._kv.stats)
        chunks0, hits0 = len(dec._chunk_trace), dec.stats["prefix_hits"]
        codes0 = _served_codes()
        _zero_pa_counts()
        t0 = time.perf_counter()
        out_a = _http_rows(DataFrame, object_col, rows[:c["async_rows"]],
                           c["concurrency"], eng.address, times["async"])
        t1 = time.perf_counter()
        out_s = _http_rows(DataFrame, object_col, rows[c["async_rows"]:], 1,
                           eng.address, times["single"])
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        launches = _launch_split(
            "25a f32", dec._kv.stats["attn_ticks_kernel"]
            - stats0["attn_ticks_kernel"], len(dec._chunk_trace) - chunks0,
            dec.stats["prefix_hits"] - hits0, cfg.layers, True)
        codes = {k: v - codes0.get(k, 0) for k, v in _served_codes().items()
                 if v - codes0.get(k, 0)}
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    got = [r["tokens"] if r else None for r in
           list(out_a["reply"]) + list(out_s["reply"])]
    errs = [e for e in list(out_a["error"]) + list(out_s["error"])
            if e is not None]
    if errs:
        raise AssertionError(f"25a: {len(errs)} rows errored, first "
                             f"{errs[0]}")
    ref = ContinuousDecoder(params_np, cfg, **settings)
    reqs = [ref.submit(np.asarray(p), c["max_new"]) for p in prompts]
    _drive(ref, reqs)
    ref.flush()
    want = [ref.result(r, timeout=1) for r in reqs]
    del ref
    torch.cuda.empty_cache()
    bad = [i for i in range(n_rows) if got[i] != want[i]]
    if bad:
        raise AssertionError(f"25a f32: rows {bad[:8]} (of {len(bad)}) "
                             f"differ from the in-process decoder, first "
                             f"{got[bad[0]]} vs {want[bad[0]]}")
    if codes != {"200": n_rows}:
        raise AssertionError(f"25a: the server answered {codes}, want "
                             f"{n_rows} x 200")
    every = sorted(times["async"] + times["single"])
    rec = {"rows": n_rows, "async_rows": c["async_rows"],
           "single_rows": c["single_rows"],
           "concurrency": c["concurrency"], "max_new": c["max_new"],
           "async_rows_per_s": c["async_rows"] / (t1 - t0),
           "single_rows_per_s": c["single_rows"] / (t2 - t1),
           "async_wall_s": t1 - t0, "single_wall_s": t2 - t1,
           "tok_per_s_async": c["async_rows"] * c["max_new"] / (t1 - t0),
           "client_s_p50": statistics.median(every),
           "client_s_max": every[-1],
           "client_s_p50_async": statistics.median(times["async"]),
           "client_s_p50_single": statistics.median(times["single"]),
           "server_codes": codes, "launches": launches}
    log(f"[25a http generation] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def nab_week_like(series, points, seed=25):
    """``series`` synthetic series of ``points`` 5-minute values (a daily
    cycle, noise, a level each series, ~0.2% spikes), as the group /
    timestamp / value columns ``SimpleDetectAnomalies`` reads."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(points)
    day = np.sin(2 * np.pi * t / 288.0)                   # 288 points a day
    level = rng.uniform(10, 1000, (series, 1))
    vals = level * (1 + 0.2 * day) + rng.standard_normal(
        (series, points)) * level * 0.05
    spikes = rng.random((series, points)) < 0.002
    vals[spikes] += level.repeat(points, 1)[spikes] * rng.uniform(
        0.5, 2.0, spikes.sum())
    groups = np.repeat(np.array([f"s{i:04d}" for i in range(series)],
                                dtype=object), points)
    return groups, np.tile(t * 300, series), vals.reshape(-1)


def phase_local_anomaly(dev_info):
    """25b: ``SimpleDetectAnomalies`` without a url on the card against
    the port's plain path (``device="cpu"``) on the same frame."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.services import SimpleDetectAnomalies
    c = P25
    groups, ts, vals = nab_week_like(c["series"], c["points"])
    df = DataFrame({"group": groups, "timestamp": ts, "value": vals})
    runs = {}
    for name, device in (("card", None), ("card_warm", None),
                         ("cpu", "cpu")):
        t = SimpleDetectAnomalies(device=device, output_col="an",
                                  error_col="err")
        t0 = time.perf_counter()
        out = t.transform(df)
        wall = time.perf_counter() - t0
        an = out["an"]
        runs[name] = {"wall_s": wall, **t.phase_seconds,
                      "scores": np.fromiter((d["score"] for d in an),
                                            np.float32, len(an)),
                      "flags": np.fromiter((d["isAnomaly"] for d in an),
                                           bool, len(an))}
        del out, an
    card, cpu = runs["card_warm"], runs["cpu"]
    for key in ("card", "card_warm"):
        r = runs[key]
        if not np.array_equal(r["scores"].view(np.int32),
                              cpu["scores"].view(np.int32)) or \
                not np.array_equal(r["flags"], cpu["flags"]):
            diff = int((r["scores"].view(np.int32)
                        != cpu["scores"].view(np.int32)).sum())
            raise AssertionError(f"25b {key}: {diff} scores differ from "
                                 f"device='cpu'")
    n_flag = int(card["flags"].sum())
    if not 0 < n_flag < len(vals) // 50:
        raise AssertionError(f"25b: {n_flag} of {len(vals)} rows flagged")
    torch.cuda.empty_cache()
    rec = {"rows": len(vals), "series": c["series"],
           "points": c["points"], "flagged": n_flag,
           **{name: {k: v for k, v in r.items()
                     if k not in ("scores", "flags")}
              for name, r in runs.items()}}
    log(f"[25b local anomaly] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _sentiment_mock(shed):
    """An in-process text-sentiment service shaped as the JAX tests' mock
    (``tests/test_services.py``): the key header checked, the document's
    id, sentiment and text length answered; with ``shed``, every other call answers 429
    + ``Retry-After: 0``. Returns (server, counts)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    counts = {"calls": 0, "429": 0, "200": 0, "bad": 0}
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # headers and body leave in two writes: without TCP_NODELAY the
        # body waits out the client's delayed ACK
        disable_nagle_algorithm = True

        def log_message(self, *a):
            pass

        def _reply(self, code, obj, headers=()):
            out = json.dumps(obj).encode()
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n))
            with lock:
                counts["calls"] += 1
                shed_now = shed and counts["calls"] % 2 == 1
                if shed_now:
                    counts["429"] += 1
            if shed_now:
                return self._reply(429, {"error": "slow down"},
                                   [("Retry-After", "0")])
            docs = body.get("documents") or []
            if self.path != "/text/sentiment" or len(docs) != 1 or \
                    self.headers.get("Ocp-Apim-Subscription-Key") != \
                    "secret" or not docs[0].get("text"):
                with lock:
                    counts["bad"] += 1
                return self._reply(400, {"error": "unexpected request"})
            doc = docs[0]
            with lock:
                counts["200"] += 1
            self._reply(200, {"documents": [
                {"id": doc["id"], "sentiment": "positive"
                 if "good" in doc["text"] else "negative",
                 "confidenceScores": {"positive": len(doc["text"])}}]})

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, args=(0.05,),
                     daemon=True).start()
    return httpd, counts


def _sentiment_run(n, shed):
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.core.dataframe import object_col
    from mmlspark_tpu_torch.services import TextSentiment
    texts = [f"{'good' if i % 3 else 'bad'} review {i}" for i in range(n)]
    httpd, counts = _sentiment_mock(shed)
    try:
        t = TextSentiment(url=f"http://127.0.0.1:{httpd.server_address[1]}"
                              "/text/sentiment", output_col="out",
                          error_col="err", concurrency=P25["concurrency"])
        t.set_scalar_param("subscription_key", "secret")
        t.set_vector_param("text", "txt")
        t0 = time.perf_counter()
        out = t.transform(DataFrame({"txt": object_col(texts)}))
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
    what = "25c shed" if shed else "25c"
    errs = [e for e in out["err"] if e is not None]
    if errs:
        raise AssertionError(f"{what}: {len(errs)} rows errored, first "
                             f"{errs[0]}")
    for i, (o, text) in enumerate(zip(out["out"], texts)):
        want = "positive" if "good" in text else "negative"
        if o is None or o.get("sentiment") != want or \
                o.get("confidenceScores") != {"positive": len(text)}:
            raise AssertionError(f"{what}: row {i} came back {o}")
    if counts["200"] != n or counts["bad"]:
        raise AssertionError(f"{what}: the mock counted {counts}")
    if shed and counts["429"] < n // 2:
        raise AssertionError(f"{what}: only {counts['429']} calls shed")
    return {"rows": n, "wall_s": wall, "rows_per_s": n / wall, **counts}


def phase_http_transport(dev_info):
    """25c: the standard-library transport on the card machine's Python,
    host only."""
    rec = {"plain": _sentiment_run(P25["sentiment_rows"], False),
           "shed_every_other": _sentiment_run(P25["shed_rows"], True),
           "concurrency": P25["concurrency"]}
    log(f"[25c http transport] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


# ---- phase 26: the distributed serving plane ---------------------------------

#: phase 26 at FULL's widths. 26a: worker-0's decoder holds ``sessions``
#: sessions (seeded prompts of ``prompt`` tokens, ``new`` new tokens each)
#: and is drained to worker-1 after ``steps`` steps; 26b: worker-1's f32
#: decoder journals ``kill_sessions`` sessions, and its heartbeats stop
#: ``kill_steps`` steps after the last prompt's prefill, its prompts prefilled in chunks of
#: ``kill_chunk`` (so the cold restore re-prefills through K1's extends);
#: ``liveness`` (s) is the driver's sweep
#: interval there (a dead verdict after 3 of them without a heartbeat),
#: ``heartbeat`` the workers'; 26c: bench.py's scenario phase
#: (``bench.py:866-905``) on the port
P26 = dict(sessions=16, prompt=(128, 448), new=64, steps=24,
           max_slots=16, max_len=512, page_size=16, prefill_chunk=512,
           kill_sessions=4, kill_prompt=(64, 256), kill_new=32,
           kill_steps=8, kill_chunk=128, liveness=1.0, heartbeat=0.1,
           scenarios=("smoke", "decode-kill"), service_s=0.005, batch=16)


def _p26_prompts(n, lo, hi, vocab, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


def _p26_engine(params_np, cfg, kv_dtype=None, **kw):
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    c = P26
    kw.setdefault("prefill_chunk", c["prefill_chunk"])
    return ContinuousDecoder(params_np, cfg, kv_dtype=kv_dtype,
                             max_slots=c["max_slots"], max_len=c["max_len"],
                             page_size=c["page_size"], **kw)


def _p26_uninterrupted(params_np, cfg, kv_dtype, prompts, new, **kw):
    import torch
    eng = _p26_engine(params_np, cfg, kv_dtype, **kw)
    reqs = [eng.submit(p, new) for p in prompts]
    _drive(eng, reqs)
    eng.flush()
    out = [eng.session_result(r, timeout=1) for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return out


def _adopting_handler(worker, eng, adopted):
    """``worker``'s ``/_adopt`` on ``eng``: each session restored warm
    (with its page blob) or cold; the restores' seconds (the stream
    synchronized) go into ``adopted["restore_s"]``."""
    import torch

    def handler(payload):
        entries = payload.get("sessions") or []
        t0 = time.perf_counter()
        for entry in entries:
            req = eng.restore_session(entry["session"],
                                      kv_blob=entry.get("kv"))
            adopted["reqs"].append((req, entry.get("kv")))
        torch.cuda.synchronize()
        adopted["restore_s"] += time.perf_counter() - t0
        adopted["at"] = time.time()
        return {"ok": True, "adopted": len(entries),
                "mode": payload.get("mode", "cold"),
                "worker": worker.worker_id}
    return handler


def _b64_raw(s):
    return len(s) * 3 // 4 - s[-2:].count("=")


def _warm_drain(params_np, dev_info, kv_dtype, name, jdir):
    """26a for one page dtype: the drain of worker-0's live sessions to
    worker-1's decoder over ``/_adopt``. Returns its record."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.serving.distributed import ServingCluster
    c = P26
    cfg = _full_cfg(torch.bfloat16)
    prompts = _p26_prompts(c["sessions"], *c["prompt"], cfg.vocab, 26)
    want = _p26_uninterrupted(params_np, cfg, kv_dtype, prompts, c["new"])
    cluster = ServingCluster(3, reply_timeout=60.0, journal_dir=jdir)
    try:
        src = _p26_engine(params_np, cfg, kv_dtype)
        reqs = [src.submit(p, c["new"], session_id=f"26a-{name}-{i}")
                for i, p in enumerate(prompts)]
        for _ in range(c["steps"]):
            src.step()
        if not all(r.tokens and not r.done for r in reqs):
            raise AssertionError(f"26a {name}: not every session decoding "
                                 f"after {c['steps']} steps")
        dst = _p26_engine(params_np, cfg, kv_dtype)
        exported = {"s": 0.0, "entries": []}

        def exporter():
            t0 = time.perf_counter()
            out = [src.checkpoint_session(r) for r in reqs]
            exported["s"] = time.perf_counter() - t0
            exported["entries"] = out
            return out

        adopted = {"reqs": [], "restore_s": 0.0}
        w0, w1 = cluster.worker("worker-0"), cluster.worker("worker-1")
        w0.session_exporter = exporter
        w1.adopt_handler = _adopting_handler(w1, dst, adopted)
        prefills0 = dst.stats["prefills"]
        t0 = time.perf_counter()
        out = cluster.drain_worker("worker-0", target_id="worker-1")
        drain_s = time.perf_counter() - t0
        entries = exported["entries"]
        if out.get("adopted") != len(reqs) or out.get("mode") != "warm" or \
                any(e["kv"] is None for e in entries):
            raise AssertionError(f"26a {name}: drain answered {out}")
        if "worker-0" in cluster.driver.routing_table() or \
                [w.worker_id for w in cluster.workers] != \
                ["worker-1", "worker-2"]:
            raise AssertionError(f"26a {name}: worker-0 still routed")
        # the adopted pages, before any step writes the next position
        for req, blob in adopted["reqs"]:
            _blob_bytes_equal(f"26a {name} adopt", blob, dst._kv,
                              dst._slot_pages[dst._slot_of(req)]
                              [:blob["n_pages"]])
        raw = sum(_b64_raw(e["kv"]["data"][i][k]) for e in entries
                  for i in range(len(e["kv"]["data"]))
                  for k in e["kv"]["data"][i])
        wire = len(json.dumps({"sessions": entries, "mode": "warm",
                               "from": "worker-0"}))
        positions = sum(e["kv"]["length"] for e in entries)
        del src, entries, exported["entries"]
        torch.cuda.synchronize()
        _zero_pa_counts()
        stats0 = dict(dst._kv.stats)
        chunks0 = len(dst._chunk_trace)
        got_reqs = [r for r, _ in adopted["reqs"]]
        _drive(dst, got_reqs)
        dst.flush()
        got = [dst.session_result(r, timeout=1) for r in got_reqs]
        launches = _launch_split(
            f"26a {name}", dst._kv.stats["attn_ticks_kernel"]
            - stats0["attn_ticks_kernel"],
            len(dst._chunk_trace) - chunks0, 0, cfg.layers, False)
        prefills = dst.stats["prefills"] - prefills0
        del dst
    finally:
        cluster.close()
        torch.cuda.empty_cache()
    same = [a == b for a, b in zip(got, want)]
    if not all(same):
        raise AssertionError(f"26a {name}: {same.count(False)} of "
                             f"{len(same)} sessions part from the "
                             f"uninterrupted decoder's tokens")
    if prefills != 0 or launches["extends"] != 0:
        raise AssertionError(f"26a {name}: the adopting decoder prefilled "
                             f"({prefills} prefills)")
    rec = {"pages": name, "sessions": len(reqs),
           "prompt_tokens": [int(p.size) for p in prompts],
           "positions_shipped": positions, "blob_bytes_raw": raw,
           "blob_bytes_json": wire,
           "bytes_per_position": raw / positions,
           "drain_s": drain_s, "export_s": exported["s"],
           "restore_s": adopted["restore_s"],
           "ms_per_adopted_session": drain_s * 1e3 / len(reqs),
           "restore_ms_per_session": adopted["restore_s"] * 1e3 / len(reqs),
           "identical_sessions": len(same), "reprefills": prefills,
           "launches_after_adopt": launches, "routing_after":
           ["worker-1", "worker-2"]}
    log(f"[26a {name}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_cluster_failover(params_np, dev_info):
    """26a (bf16, then int8 pages) and 26b (f32)."""
    import shutil
    jdir = os.path.join(HERE, "build", "phase26")
    shutil.rmtree(jdir, ignore_errors=True)
    os.makedirs(jdir)
    out = {}
    for name, kv in (("bf16", None), ("int8", "int8")):
        _zero_pa_counts()
        out[name] = _warm_drain(params_np, dev_info, kv, name,
                                os.path.join(jdir, f"a-{name}"))
    out["f32_kill"] = _cold_kill(params_np, dev_info,
                                 os.path.join(jdir, "b"))
    return out


def _cold_kill(params_np, dev_info, jdir):
    """26b: worker-1's f32 decoder journals its sessions into worker-1's
    server journal; its heartbeats stop without a goodbye; the driver's
    sweeper declares it dead and the cluster replays the journal onto
    worker-2's decoder over ``/_adopt``, a cold restore (re-prefill)."""
    import torch
    from mmlspark_tpu_torch.serving.distributed import ServingCluster
    c = P26
    cfg = _full_cfg(torch.float32)
    prompts = _p26_prompts(c["kill_sessions"], *c["kill_prompt"], cfg.vocab,
                           126)
    chunk = {"prefill_chunk": c["kill_chunk"]}
    want = _p26_uninterrupted(params_np, cfg, None, prompts, c["kill_new"],
                              **chunk)
    os.makedirs(jdir)
    cluster = ServingCluster(3, reply_timeout=60.0,
                             liveness_interval=c["liveness"],
                             heartbeat_interval=c["heartbeat"],
                             journal_dir=jdir)
    try:
        # as after 26a: worker-0 leaves (an empty drain), so worker-2 is
        # the survivor the dead worker's sessions go to
        cluster.drain_worker("worker-0")
        verdict = {}
        # ahead of the cluster's own callback, which does the reassignment
        cluster.driver._dead_callbacks.insert(
            0, lambda wid, info: verdict.setdefault(
                wid, (time.time(), info["last_seen"])))
        w1, w2 = cluster.worker("worker-1"), cluster.worker("worker-2")
        src = _p26_engine(params_np, cfg, journal=w1.server._journal,
                          **chunk)
        reqs = [src.submit(p, c["kill_new"], session_id=f"26b-{i}")
                for i, p in enumerate(prompts)]
        # every prompt's chunks, then kill_steps decode steps
        for _ in range(400):
            if all(r.tokens for r in reqs):
                break
            src.step()
        for _ in range(c["kill_steps"]):
            src.step()
        if not all(r.tokens and not r.done for r in reqs):
            raise AssertionError("26b: not every session decoding")
        dst = _p26_engine(params_np, cfg, **chunk)
        adopted = {"reqs": [], "restore_s": 0.0}
        w2.adopt_handler = _adopting_handler(w2, dst, adopted)
        emitted = {r.session_id: len(r.tokens) for r in reqs}
        t_stop = time.time()
        w1._hb_stop.set()
        w1._hb_thread.join(timeout=5)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                len(adopted["reqs"]) < len(reqs):
            time.sleep(0.02)
        got_reqs = [r for r, _ in adopted["reqs"]]
        if len(got_reqs) != len(reqs) or "worker-1" not in verdict:
            raise AssertionError(f"26b: {len(got_reqs)} of {len(reqs)} "
                                 f"sessions reassigned; verdict {verdict}")
        t_dead, last_seen = verdict["worker-1"]
        t_adopt = adopted["at"]
        del src
        torch.cuda.synchronize()
        _zero_pa_counts()
        stats0 = dict(dst._kv.stats)
        chunks0 = len(dst._chunk_trace)
        prefills0 = dst.stats["prefills"]
        _drive(dst, got_reqs)
        dst.flush()
        by_id = {r.session_id: dst.session_result(r, timeout=1)
                 for r in got_reqs}
        got = [by_id[f"26b-{i}"] for i in range(len(reqs))]
        chunks = len(dst._chunk_trace) - chunks0
        launches = _launch_split(
            "26b", dst._kv.stats["attn_ticks_kernel"]
            - stats0["attn_ticks_kernel"], chunks, 0, cfg.layers, True)
        rec = {"sessions": len(reqs),
               "prompt_tokens": [int(p.size) for p in prompts],
               "emitted_at_kill": emitted,
               "heartbeat_stop_to_dead_s": t_dead - t_stop,
               "last_heartbeat_to_dead_s": t_dead - last_seen,
               "last_heartbeat_to_adopt_s": t_adopt - last_seen,
               "restore_s": adopted["restore_s"],
               "reprefill_chunks": chunks,
               "prefills": dst.stats["prefills"] - prefills0,
               "launches": launches,
               "routing_after": sorted(cluster.driver.routing_table())}
        del dst
    finally:
        cluster.close()
        torch.cuda.empty_cache()
    same = [a == b for a, b in zip(got, want)]
    tokens = sum(len(w) for w in want)
    rec["identical_sessions"] = same.count(True)
    rec["identical_token_share"] = sum(
        x == y for a, b in zip(got, want) for x, y in zip(a, b)) / tokens
    if not all(same):
        rec["divergence"] = _divergence_gaps(
            params_np, cfg, prompts, got, want)
        raise AssertionError(f"26b: f32 cold restore parts from the "
                             f"uninterrupted decoder: {json.dumps(rec)}")
    if "worker-1" in rec["routing_after"] or rec["reprefill_chunks"] < 1:
        raise AssertionError(f"26b: {json.dumps(rec)}")
    log(f"[26b] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_cluster_harness(dev_info):
    """26c: bench.py's scenario phase on the port: each of ``P26``'s
    scenarios against a fresh 3-worker cluster behind the echo engine;
    host numbers."""
    import threading as _threading
    from mmlspark_tpu_torch.loadgen import (cluster_echo_engine,
                                            get_scenario, run_scenario)
    from mmlspark_tpu_torch.observability.federation import (
        FEDERATION_INTERVAL_ENV)
    from mmlspark_tpu_torch.serving.distributed import ServingCluster
    c = P26
    prior = os.environ.get(FEDERATION_INTERVAL_ENV)
    os.environ[FEDERATION_INTERVAL_ENV] = "0"   # federate every heartbeat
    out = {}
    try:
        for name in c["scenarios"]:
            cluster = ServingCluster(3, reply_timeout=10.0, max_queue=256)
            stop = _threading.Event()
            engine = cluster_echo_engine(cluster, stop,
                                         service_s=c["service_s"],
                                         batch=c["batch"])
            live = []
            url = cluster.workers[0].server.address + "debug/scenario"

            def poll():
                # a few reads early in the run, then quiet: each GET is a
                # served request, and one landing in the scenario's
                # quiesced window would break its exact reconciliation
                while len(live) < 3 and not stop.is_set():
                    try:
                        _, snap = _get_json(url, timeout=5)
                        if snap.get("state") == "running" and \
                                snap.get("scenario") == name:
                            live.append(snap)
                    except OSError:
                        pass
                    time.sleep(0.1)

            poller = _threading.Thread(target=poll, daemon=True)
            poller.start()
            t0 = time.perf_counter()
            try:
                card = run_scenario(get_scenario(name), cluster,
                                    closed_loop_n=20, mesh_shape="single")
            finally:
                stop.set()
                engine.join(timeout=2.0)
                poller.join(timeout=6.0)
                cluster.close()
            cl, sess = card["cluster"] or {}, card["sessions"]
            rec = {"wall_s": time.perf_counter() - t0,
                   "arrivals": card["arrivals"], "ok": card["ok"],
                   "shed": card["shed"], "errors": card["errors"],
                   "lost": card["lost"], "goodput_rps": card["goodput_rps"],
                   "open_loop_latency_ms": card["latency_ms"],
                   "closed_loop_latency_ms":
                   card["closed_loop"]["latency_ms"],
                   "fairness_error": card["fairness_error"],
                   "retry": card["retry"], "cluster": cl,
                   "sessions": sess, "debug_scenario_running_reads":
                   len(live), "note": "host numbers (echo engine, no "
                                      "device work)"}
            if cl.get("reconciled") is not True or card["lost"] != 0 or \
                    card["ok"] + card["shed"] + card["errors"] != \
                    card["arrivals"] or not live:
                raise AssertionError(f"26c {name}: {json.dumps(rec)}")
            if name == "decode-kill" and (
                    sess is None or sess["lost"] != 0
                    or sess["recovered"] < 1):
                raise AssertionError(f"26c {name}: sessions {sess}")
            out[name] = rec
            log(f"[26c {name}] {json.dumps(rec)} | {dev_info['smi']}")
    finally:
        if prior is None:
            os.environ.pop(FEDERATION_INTERVAL_ENV, None)
        else:
            os.environ[FEDERATION_INTERVAL_ENV] = prior
    return out


# phase 27: the main path on a dp2 x tp2 mesh of four gloo ranks sharing
# the card (bench.py:765-860's _multichip_generation_phase at 4 chips)
P27 = dict(dp=2, tp=2, slots=16, max_len=1024, page_size=16,
           prefill_chunk=256, steps_per_dispatch=4, requests=16,
           spec_gamma=2)


def _p27_payloads(vocab):
    """27d's 16 requests: phase 5's twelve (the prefix owner at index 9,
    an SSE stream last) and four more prompts of 32, 128, 384 and 48
    tokens, ``PARITY_NEW`` new tokens each."""
    import numpy as np
    payloads = _serving_payloads(vocab, PARITY_NEW)
    rng = np.random.default_rng(27)
    payloads += [{"tokens": [int(t) for t in rng.integers(0, vocab, n)],
                  "max_new": PARITY_NEW} for n in (32, 128, 384, 48)]
    return payloads


def _pool_digests(eng, pages=None):
    """sha1 of every layer's buffers, as bytes: off trash page 0, or of
    ``pages`` in order."""
    import hashlib
    import torch
    idx = None if pages is None else torch.as_tensor(pages).to(eng._dev)
    out = []
    for c in eng._kv.buffers:
        out.append({k: hashlib.sha1(
            (b.view(torch.uint8)[1:] if idx is None
             else b.view(torch.uint8)[idx]).contiguous().cpu().numpy()
            .tobytes()).hexdigest() for k, b in c.items()})
    return out


def _p27_counts(eng, stats0, chunks0, hits0):
    """An engine run's attention calls, prefill chunks and prefix hits
    since the given marks, and the (K1, K2, K5a, K5b) launches and K5
    bodies since the last zeroing."""
    return {"calls": (eng._kv.stats["attn_ticks_kernel"]
                      - stats0["attn_ticks_kernel"]),
            "gather_bytes": (eng._kv.stats["gather_bytes"]
                             - stats0["gather_bytes"]),
            "chunks": len(eng._chunk_trace) - chunks0,
            "hits": eng.stats["prefix_hits"] - hits0,
            "launches": list(_pa_counts()), "bodies": _bodies("window")}


def _p27_drain(eng, reqs):
    for _ in range(2000):
        if all(r.done for r in reqs):
            break
        eng.step()
    eng.flush()
    return [eng.result(r, timeout=1) for r in reqs]


def _p27_parity(params_np, cfg, mesh, kv_dtype=None, draft=None):
    """27a's f32 and 27b's int8 runs (27c's f32 and bf16 ones with
    ``draft``, a (params, cfg) pair at gamma P27["spec_gamma"]): phase
    4's engine (4 slots, 2 a dp shard) on the parity prompts,
    ``PARITY_NEW`` tokens each."""
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    kw = ({} if draft is None else
          {"draft_params": draft[0], "draft_cfg": draft[1],
           "gamma": P27["spec_gamma"]})
    eng = ContinuousDecoder(params_np, cfg, kv_dtype=kv_dtype, mesh=mesh,
                            **kw, **PARITY)
    _zero_pa_counts()
    toks = _p27_drain(eng, [eng.submit(p, PARITY_NEW)
                            for p in _parity_prompts(cfg.vocab)])
    rec = {"tokens": toks, **_p27_counts(eng, {"attn_ticks_kernel": 0,
                                                "gather_bytes": 0}, 0, 0),
           "slot_axis": eng._slot_axis,
           "rows": [eng._rows.start, eng._rows.stop],
           "verify_windows": eng.stats.get("spec_verify_windows", 0),
           "digests": _pool_digests(eng)}
    if draft is not None:
        rec["tokens_per_round_slot"] = (eng.stats["spec_emitted"]
                                        / eng.stats["spec_round_slots"])
    return rec


def _p27_serve(params_np, cfg, mesh):
    """27a's bf16 run: phase 6's mix through a 16-slot engine (8 a dp
    shard on the mesh, ``mesh=None`` the single-device yardstick):
    tokens, tokens/s, p50 tick, the K5 launches by body, dp exchanges a
    tick, and the pool's digests."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.parallel.mesh import gather_rows_many
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    eng = ContinuousDecoder(
        params_np, cfg, mesh=mesh, max_slots=P27["slots"],
        max_len=P27["max_len"], page_size=P27["page_size"],
        prefill_chunk=P27["prefill_chunk"],
        steps_per_dispatch=P27["steps_per_dispatch"])
    warm = eng.submit([1, 2, 3], 4)     # cuBLAS handles, allocator
    while not warm.done:
        eng.step()
    eng.tick_seconds.clear()
    stats0, hits0 = dict(eng._kv.stats), eng.stats["prefix_hits"]
    chunks0 = len(eng._chunk_trace)
    gathers0 = gather_rows_many.calls
    _zero_pa_counts()
    reqs, wall = _serve_mix(eng, np.random.default_rng(3), cfg.vocab,
                            [32, 128, 384] * 3, 64)
    ticks = list(eng.tick_seconds)
    n_tok = sum(len(r.tokens) for r in reqs)
    rec = {"tokens": [eng.result(r, timeout=1) for r in reqs],
           **_p27_counts(eng, stats0, chunks0, hits0),
           "tok_per_s": n_tok / wall, "n_tokens": n_tok, "wall_s": wall,
           "p50_tick_ms": statistics.median(ticks) * 1e3,
           "ticks": len(ticks),
           "dp_exchanges": gather_rows_many.calls - gathers0,
           "digests": _pool_digests(eng) if mesh is not None else None}
    del eng
    torch.cuda.empty_cache()
    return rec


def _host_wall_ms(fn, reps):
    """Host wall ms a call of ``fn`` (each ending in its own wait), over
    ``reps`` calls after a warm-up; the card synchronized at both ends."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _p27_exchange(mesh, cfg):
    """The dp exchange alone at 27a's bf16 decode step: one mount's
    gather of a shard's 8 rows (k_new and v_new of its 6 heads, block
    table of 64 pages, pos, active) and the dispatch's join of 8 rows of
    k = 4 tokens and the four state vectors (``tok``, ``pos``, ``active``,
    ``remaining``); host ms a call."""
    import torch
    from mmlspark_tpu_torch.parallel.mesh import gather_rows_many
    from mmlspark_tpu_torch.utils.device import resolve_device
    dev = resolve_device()
    n = P27["slots"] // P27["dp"]
    h, hd = cfg.heads // P27["tp"], cfg.d_model // cfg.heads
    kv = [torch.zeros(n, h, 1, hd, dtype=torch.bfloat16, device=dev)
          for _ in range(2)]
    meta = [torch.zeros(n, P27["max_len"] // P27["page_size"],
                        dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev)]
    join = [torch.zeros(n, P27["steps_per_dispatch"], dtype=torch.int32,
                        device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev)]
    mount = _host_wall_ms(lambda: gather_rows_many(kv + meta, mesh, "dp"), 100)
    joined = _host_wall_ms(lambda: gather_rows_many(join, mesh, "dp"), 100)
    per_tick = cfg.layers * P27["steps_per_dispatch"] * mount + joined
    return {"mount_gather_ms": mount, "join_gather_ms": joined,
            "ms_per_tick": per_tick}


def _p27_http(params_np, cfg, mesh, payloads):
    """27d: ``GenerationEngine(mesh=)``: rank 0 answers ``payloads`` over
    HTTP (the prefix owner first, the other 15 at once), the other ranks
    follow. Rank 0's (status, body) replies."""
    from mmlspark_tpu_torch.serving.generation import GenerationEngine
    eng = GenerationEngine(
        params_np, cfg, mesh=mesh, max_slots=P27["slots"],
        max_len=P27["max_len"], page_size=P27["page_size"],
        prefill_chunk=P27["prefill_chunk"],
        steps_per_dispatch=P27["steps_per_dispatch"])
    replies = {}
    eng.start()
    try:
        if eng.leader:
            def client(i):
                try:
                    st, body = _post(eng.address, payloads[i])
                    replies[i] = (st, body.decode())
                except Exception as e:   # recorded, checked in the parent
                    replies[i] = (None, repr(e))
            client(9)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(payloads)) if i != 9]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
    finally:
        eng.stop()
    return {"leader": eng.leader,
            "replies": [replies.get(i) for i in range(len(payloads))]
            if eng.leader else None}


def _p27_failover(params_np, cfg, mesh):
    """27d's failover: the parity prompts on phase 4's engine over the
    mesh; the 300-token session is checkpointed once it has emitted 4
    tokens (its pages exported from the tp = 2 pool, heads gathered),
    then the engine runs to the end. The blob (rank 0's; every rank's
    sha1), this rank's shard digests of the blob's pages, and the
    uninterrupted tokens."""
    import hashlib
    import torch.distributed as dist
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    eng = ContinuousDecoder(params_np, cfg, mesh=mesh, **PARITY)
    reqs = [eng.submit(p, PARITY_NEW) for p in _parity_prompts(cfg.vocab)]
    req = reqs[2]
    for _ in range(400):
        if len(req.tokens) >= 4:
            break
        eng.step()
    ck = eng.checkpoint_session(req)
    n = ck["kv"]["n_pages"]
    shard = _pool_digests(eng, eng._slot_pages[eng._slot_of(req)][:n])
    _p27_drain(eng, reqs)
    blob = json.dumps(ck, sort_keys=True).encode()
    return {"checkpoint": ck if dist.get_rank() == 0 else None,
            "checkpoint_sha1": hashlib.sha1(blob).hexdigest(),
            "shard_digests": shard, "emitted_at_export": len(
                ck["session"]["emitted"]),
            "uninterrupted": eng.session_result(req)}


def _p27_rank(mesh):
    """One rank of phase 27: the f32 full-width model (seed 0, its tp
    shard) and 13b's target and draft (seeds 0 and 1); 27a's f32 and bf16
    runs, 27b's int8 run, the dp exchange timed alone, 27c's speculative
    runs, 27d's HTTP front and failover export."""
    import torch
    import torch.distributed as dist
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    from mmlspark_tpu_torch.parallel.mesh import axis_rank
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    secs = {}

    def lap(name):
        nonlocal t0
        secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    cfg = _full_cfg(torch.float32)
    params_np = init_transformer(cfg, seed=0)
    lap("init")
    out = {"dp": axis_rank(mesh, "dp"), "tp": axis_rank(mesh, "tp"),
           "backend": dist.get_backend(),
           "a_f32": _p27_parity(params_np, cfg, mesh)}
    lap("27a f32")
    out["b_int8"] = _p27_parity(params_np, cfg, mesh, "int8")
    lap("27b int8")
    bf16 = _full_cfg(torch.bfloat16)
    out["a_bf16"] = _p27_serve(params_np, bf16, mesh)
    out["exchange"] = _p27_exchange(mesh, bf16)
    lap("27a bf16")
    out["d_http"] = _p27_http(params_np, cfg, mesh, _p27_payloads(cfg.vocab))
    lap("27d http")
    out["d_failover"] = _p27_failover(params_np, cfg, mesh)
    lap("27d failover")
    del params_np
    t_cfg, d_cfg = _spec_cfgs(torch.float32)
    t_np, d_np = init_transformer(t_cfg, 0), init_transformer(d_cfg, 1)
    out["c_f32"] = _p27_parity(t_np, t_cfg, mesh, draft=(d_np, d_cfg))
    t16, d16 = _spec_cfgs(torch.bfloat16)
    out["c_bf16"] = _p27_parity(t_np, t16, mesh, draft=(d_np, d16))
    lap("27c")
    out["wall_s"] = secs
    return out


def _p27_http_reference(params_np, cfg, payloads):
    """27d's yardstick: the in-process single-device f32 decoder on the
    same requests (the prefix owner drained first, as the front's client
    sends it), greedy tokens per request."""
    import torch
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    eng = ContinuousDecoder(
        params_np, cfg, max_slots=P27["slots"], max_len=P27["max_len"],
        page_size=P27["page_size"], prefill_chunk=P27["prefill_chunk"],
        steps_per_dispatch=P27["steps_per_dispatch"])

    def submit(p):
        return eng.submit(p["tokens"], p["max_new"],
                          prefix_key=p.get("prefix_key"),
                          prefix_len=p.get("prefix_len"))

    want = {9: _p27_drain(eng, [submit(payloads[9])])[0]}
    rest = [i for i in range(len(payloads)) if i != 9]
    want.update(zip(rest, _p27_drain(eng, [submit(payloads[i])
                                           for i in rest])))
    del eng
    torch.cuda.empty_cache()
    return [want[i] for i in range(len(payloads))]


def _reply_tokens(payload, body):
    """The tokens of one reply: the JSON body, or an SSE stream's final
    event (its streamed tokens must add up to it)."""
    if not payload.get("stream"):
        return json.loads(body)["tokens"]
    events = [json.loads(line[6:]) for line in body.split("\n\n")
              if line.startswith("data: ")]
    final = events[-1]
    streamed = [t for e in events[:-1] for t in e.get("tokens", [])]
    if not final.get("done") or streamed != final["tokens"]:
        raise AssertionError(f"27d stream: final event {final}, streamed "
                             f"{streamed}")
    return final["tokens"]


def _p27_k5(what, r, layers, quant=False, mma=False):
    """One rank's K1/K2/K5 launches in a run: only K5a (K5b when
    ``quant``), one a layer per attention call; the decode steps on the
    split body; the extends (chunks, prefix suffixes, verify windows) on
    the tensor-core body when ``mma`` (bf16), else on the FMA body (f32:
    neither body counter moves)."""
    k1, k2, k5a, k5b = r["launches"]
    b = r["bodies"]
    q = "q_" if quant else ""
    extend = r["chunks"] + r["hits"] + r.get("verify_windows", 0)
    steps = r["calls"] - extend
    want_split = steps * layers
    want_mma = extend * layers if mma else 0
    mine, other = (k5b, k5a) if quant else (k5a, k5b)
    if k1 or k2 or other or mine != r["calls"] * layers or \
            b[q + "split"] != want_split or b[q + "mma"] != want_mma or \
            r["gather_bytes"]:
        raise AssertionError(
            f"{what}: (K1, K2, K5a, K5b) {r['launches']}, bodies {b}; want "
            f"{r['calls']} calls x {layers} layers of "
            f"{'K5b' if quant else 'K5a'}, {want_split} split, {want_mma} "
            f"tensor-core ({steps} decode steps, {extend} extends and "
            f"windows)")
    return {"launches": mine, "split": b[q + "split"], "mma": b[q + "mma"],
            "decode_steps": steps, "extends": extend}


def _p27_replicas(what, res, key):
    """The two dp replicas of each tp rank hold the same pool bytes (every
    buffer of every layer, off trash page 0)."""
    by = {(r["dp"], r["tp"]): r[key]["digests"] for r in res}
    for t in range(P27["tp"]):
        if by[(0, t)] != by[(1, t)]:
            raise AssertionError(f"{what}: tp rank {t}'s dp replicas hold "
                                 f"different pages")
    if by[(0, 0)] == by[(0, 1)]:
        raise AssertionError(f"{what}: the tp ranks hold the same pages")


def phase_mesh_dp(params_np, single, dev_info):
    """27a-27d: the serving path on a dp2 x tp2 mesh of four rank
    processes, over gloo when they share the one card (NCCL when each has
    a card of its own; see the module docstring). The single-device
    yardsticks run here first; ``single`` is phase 4's tokens."""
    import base64
    import hashlib
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    from mmlspark_tpu_torch.parallel.launch import run_ranks
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    t0 = time.perf_counter()
    cfg, bf16 = _full_cfg(torch.float32), _full_cfg(torch.bfloat16)
    _zero_pa_counts()
    yard = _p27_serve(params_np, bf16, None)
    payloads = _p27_payloads(cfg.vocab)
    want_http = _p27_http_reference(params_np, cfg, payloads)
    t_cfg, d_cfg = _spec_cfgs(torch.float32)
    t_np, d_np = init_transformer(t_cfg, 0), init_transformer(d_cfg, 1)
    want_spec, _ = _spec_parity_run(t_np, t_cfg, d_np, d_cfg, None,
                                    P27["spec_gamma"])
    del t_np, d_np
    torch.cuda.empty_cache()
    yard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run_ranks(_p27_rank, P27["dp"] * P27["tp"], device="cuda",
                    axes={"dp": P27["dp"], "tp": P27["tp"]}, timeout=900)
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    L = cfg.layers
    k5 = {}
    for r in res:
        who = f"rank dp{r['dp']} tp{r['tp']}"
        rows = [2 * r["dp"], 2 * r["dp"] + 2]
        if r["a_f32"]["slot_axis"] != "dp" or r["a_f32"]["rows"] != rows:
            raise AssertionError(f"27a {who}: slot axis "
                                 f"{r['a_f32']['slot_axis']}, rows "
                                 f"{r['a_f32']['rows']}")
        if r["a_f32"]["tokens"] != single[None]:
            raise AssertionError(f"27a f32 {who}: tokens "
                                 f"{r['a_f32']['tokens']}, single device "
                                 f"{single[None]}")
        if r["a_bf16"]["tokens"] != res[0]["a_bf16"]["tokens"]:
            raise AssertionError(f"27a bf16 {who}: tokens differ from rank "
                                 f"0's")
        if r["a_bf16"]["hits"] < 1:
            raise AssertionError(f"27a bf16 {who}: no prefix hit")
        head = [t[:4] for t in r["b_int8"]["tokens"]]
        if head != [t[:4] for t in single["int8"]]:
            raise AssertionError(f"27b int8 {who}: first 4 tokens {head}, "
                                 f"single device {single['int8']}")
        if r["c_f32"]["tokens"] != want_spec:
            raise AssertionError(f"27c f32 {who}: tokens "
                                 f"{r['c_f32']['tokens']}, single-device "
                                 f"speculative engine {want_spec}")
        if r["c_bf16"]["tokens"] != res[0]["c_bf16"]["tokens"] or \
                r["c_bf16"]["verify_windows"] < 1:
            raise AssertionError(f"27c bf16 {who}: tokens differ from rank "
                                 f"0's, or no verify window ran")
        k5[who] = {
            "27a f32": _p27_k5(f"27a f32 {who}", r["a_f32"], L),
            "27a bf16": _p27_k5(f"27a bf16 {who}", r["a_bf16"], L, mma=True),
            "27b int8": _p27_k5(f"27b int8 {who}", r["b_int8"], L,
                                quant=True),
            "27c f32": _p27_k5(f"27c f32 {who}", r["c_f32"], t_cfg.layers),
            "27c bf16": _p27_k5(f"27c bf16 {who}", r["c_bf16"],
                                t_cfg.layers, mma=True)}
    for key in ("a_f32", "a_bf16", "b_int8"):
        _p27_replicas(f"27 {key}", res, key)
    # 27d: the front's replies, then the failover
    lead = [r for r in res if r["d_http"]["leader"]]
    if len(lead) != 1 or (lead[0]["dp"], lead[0]["tp"]) != (0, 0):
        raise AssertionError(f"27d: leaders {[r['d_http'] for r in lead]}")
    replies = lead[0]["d_http"]["replies"]
    for i, (p, rep) in enumerate(zip(payloads, replies)):
        if rep is None or rep[0] != 200:
            raise AssertionError(f"27d request {i} answered {rep}")
        got = _reply_tokens(p, rep[1])
        if got != want_http[i]:
            raise AssertionError(f"27d request {i}: tokens {got}, the "
                                 f"in-process decoder's {want_http[i]}")
    fo = [r["d_failover"] for r in res]
    ck = next(f["checkpoint"] for f in fo if f["checkpoint"] is not None)
    if len({f["checkpoint_sha1"] for f in fo}) != 1:
        raise AssertionError("27d: the ranks exported different blobs")
    blob = ck["kv"]
    h = cfg.heads // P27["tp"]
    for r in res:
        for li, layer in enumerate(r["d_failover"]["shard_digests"]):
            for key, digest in layer.items():
                raw = np.frombuffer(base64.b64decode(blob["data"][li][key]),
                                    np.uint8).reshape(blob["n_pages"],
                                                      cfg.heads, -1)
                mine = raw[:, r["tp"] * h:(r["tp"] + 1) * h]
                if hashlib.sha1(np.ascontiguousarray(mine).tobytes()
                                ).hexdigest() != digest:
                    raise AssertionError(
                        f"27d: blob layer {li} {key}, heads of tp rank "
                        f"{r['tp']}, differ from the rank's shard")
    t_adopt = time.perf_counter()
    eng = ContinuousDecoder(params_np, cfg, **PARITY)
    req = eng.restore_session(ck["session"], blob)
    _p27_drain(eng, [req])
    adopt_s = time.perf_counter() - t_adopt
    adopted = eng.session_result(req)
    prefills = eng.stats["prefills"]
    del eng
    torch.cuda.empty_cache()
    if prefills or adopted != single[None][2] or any(
            f["uninterrupted"] != single[None][2] for f in fo):
        raise AssertionError(f"27d failover: {prefills} re-prefills, "
                             f"adopted {adopted}, uninterrupted "
                             f"{[f['uninterrupted'] for f in fo]}, single "
                             f"device {single[None][2]}")
    r0 = res[0]
    rec = {
        "mesh_shape": "dp2xtp2", "ranks": len(res),
        "backend": r0["backend"], "cards": torch.cuda.device_count(),
        "tok_per_sec": r0["a_bf16"]["tok_per_s"],
        "tok_per_sec_single_chip": yard["tok_per_s"],
        "p50_tick_ms": r0["a_bf16"]["p50_tick_ms"],
        "p50_tick_ms_single_chip": yard["p50_tick_ms"],
        "collective_ms_per_tick_est": max(
            0.0, r0["a_bf16"]["p50_tick_ms"] - yard["p50_tick_ms"]),
        "token_parity_vs_single_chip": (r0["a_bf16"]["tokens"]
                                        == yard["tokens"]),
        "f32_token_parity_vs_single_chip": True,
        "int8_horizon_tokens": 4, "spec_gamma": P27["spec_gamma"],
        "spec_tokens_per_round_slot_f32": r0["c_f32"][
            "tokens_per_round_slot"],
        "dp_exchange": {**r0["exchange"],
                        "exchanges_per_tick": (r0["a_bf16"]["dp_exchanges"]
                                               / r0["a_bf16"]["ticks"])},
        "http_requests": len(payloads), "http_200": len(payloads),
        "failover": {"blob_pages": blob["n_pages"],
                     "emitted_at_export": fo[0]["emitted_at_export"],
                     "re_prefills": prefills, "adopt_and_finish_s": adopt_s},
        "k5_by_rank": k5,
        "rank_wall_s": {f"dp{r['dp']}tp{r['tp']}": r["wall_s"] for r in res},
        "wall_s": {"yardsticks": yard_s, "ranks": ranks_s,
                   "checks_and_adopt": time.perf_counter() - t0}}
    log(f"[27] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _phase26(params_np, dev_info):
    """Phases 26a-26c, each sub-phase's wall seconds beside it."""
    out, secs = {}, {}
    t0 = time.perf_counter()
    failover = phase_cluster_failover(params_np, dev_info)
    secs["26a+26b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["26c"] = phase_cluster_harness(dev_info)
    secs["26c"] = time.perf_counter() - t0
    out["26a"] = {k: failover[k] for k in ("bf16", "int8")}
    out["26b"] = failover["f32_kill"]
    out["wall_s"] = secs
    out["launches"] = {
        "26a bf16": failover["bf16"]["launches_after_adopt"],
        "26a int8": failover["int8"]["launches_after_adopt"],
        "26b f32": failover["f32_kill"]["launches"]}
    log(f"[26] wall seconds {json.dumps(secs)}")
    return out


def _phase25(params_np, dev_info):
    """Phases 25a-25c, each sub-phase's wall seconds beside it."""
    out, secs = {}, {}
    for key, fn in (("25a", lambda: phase_http_generation(params_np,
                                                          dev_info)),
                    ("25b", lambda: phase_local_anomaly(dev_info)),
                    ("25c", lambda: phase_http_transport(dev_info))):
        t0 = time.perf_counter()
        out[key] = fn()
        secs[key] = time.perf_counter() - t0
    out["wall_s"] = secs
    log(f"[25] wall seconds {json.dumps(secs)}")
    return out


def _phase24(dev_info):
    """Phases 24a-24c, each sub-phase's wall seconds beside it."""
    import torch
    out, secs = {}, {}
    for key, fn in (("24a", phase_train_adult), ("24b", phase_tune_higgs),
                    ("24c", phase_text_pipeline)):
        t0 = time.perf_counter()
        out[key] = fn(dev_info)
        secs[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["wall_s"] = secs
    out["k6_launches"] = {"24a": out["24a"]["k6_launches"],
                          "24b": out["24b"]["k6_launches"]}
    log(f"[24] wall seconds {json.dumps(secs)}")
    return out


def _phase23(dev_info):
    """Phases 23a-23e, each sub-phase's wall seconds beside it."""
    import torch
    out, secs = {}, {}
    for key, fn in (("23a", phase_vw), ("23b", phase_knn),
                    ("23c", phase_sar), ("23d", phase_access_anomaly),
                    ("23e", phase_tuning)):
        t0 = time.perf_counter()
        out[key] = fn(dev_info)
        secs[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["wall_s"] = secs
    log(f"[23] wall seconds {json.dumps(secs)}")
    return out


def _phase22(dev_info):
    """Phases 22a-22e; the HIGGS matrix is made once for b and c."""
    import torch
    rank = phase_ranker(dev_info)
    torch.cuda.empty_cache()
    X, y = make_higgs_like(GBDT["rows"], GBDT["features"])
    n = P22["extra_rows"]
    extra = phase_extra_trees(dev_info, X[:n], y[:n])
    torch.cuda.empty_cache()
    ckpt = phase_checkpoints(dev_info, X, y)
    del X, y
    torch.cuda.empty_cache()
    bert = phase_onnx_finetune(dev_info)
    launches = {"22a": rank["k6_launches"],
                "22b": extra["k6_launches"] + extra["gbdt_k6_launches"],
                "22c": ckpt["k6_launches"]}
    flash = {part: {k: bert[part]["launches"][k] for k in ("k7", "k8a",
                                                          "k8b")}
             for part in ("22d", "22e")}
    flash["22d first step"] = bert["22d"]["parity"]["launches"]
    return {"22a": rank, "22b": extra, "22c": ckpt, "22d": bert["22d"],
            "22e": bert["22e"], "k6_launches": launches,
            "flash_launches": flash}


def _phase21(dev_info, hist_recs=None):
    """Phases 21a-21e; the HIGGS matrix is made once for a, b and e, the
    airline rows once for c and d."""
    import torch
    X, y = make_higgs_like(GBDT["rows"], GBDT["features"])
    X, y = X[:P21["higgs_rows"]], y[:P21["higgs_rows"]]
    modes = phase_boosting_modes(dev_info, X, y)
    torch.cuda.empty_cache()
    cons = phase_constraints(dev_info, X, y, modes["gbdt"])
    lin = phase_linear_tree(dev_info, X, y, modes["gbdt"])
    t0 = time.perf_counter()
    X, y = make_airline_like(P21["airline_rows"])
    data_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    cat = phase_categorical(dev_info, X, y, data_s)
    torch.cuda.empty_cache()
    efb = phase_efb(dev_info, X, y, hist_recs)
    del X, y
    torch.cuda.empty_cache()
    launches = {**{f"21a {k}": modes[k]["k6_launches"]
                   for k in ("gbdt", "goss", "dart", "rf")},
                "21b": cons["k6_launches"],
                **{f"21c {k}": cat[k]["k6_launches"]
                   for k in ("categorical", "numeric")},
                "21d": efb["k6_launches"], "21e": lin["k6_launches"]}
    return {"21a": modes, "21b": cons, "21c": cat, "21d": efb, "21e": lin,
            "k6_launches": launches}


def _phase20(dev_info):
    """Phases 20a-20g."""
    train, t_np, d_np, batch_fn = phase_gen_training(dev_info)
    specs = phase_gen_speculative(dev_info, t_np, d_np, batch_fn)
    beam, samp = phase_gen_beam_sampling(dev_info, t_np, batch_fn)
    return {"20a": train, "20b": specs, "20c": beam, "20d": samp,
            "20e": phase_gen_ort(dev_info),
            "20f": phase_external_data(dev_info),
            "20g": {**phase_onnx_ops(dev_info, extra_op_cases(), "20g"),
                    "random": _random_ops_on_card(dev_info)}}


def _phase19(dev_info):
    """Phases 19a-19c."""
    return {"19a": phase_afterfit_higgs(dev_info),
            "19b": phase_afterfit_more(dev_info),
            "19c": phase_onnx_ops(dev_info, ml_op_cases(), "19c")}


def _phase18(dev_info):
    """Phases 18a-18c."""
    return {"18a": phase_quant_resnet(dev_info),
            "18b": phase_quant_bert(dev_info),
            "18c": phase_onnx_ops(dev_info)}


def _phase16(params_np, single, dev_info):
    """Phases 16a-16c. The sampler period they set and the plane's
    singletons they fill are put back after them, so later phases' servers
    run as they would without phase 16."""
    import torch
    interval = os.environ.get("MMLSPARK_TPU_TS_INTERVAL")
    try:
        front = phase_plane_front(params_np, single, dev_info)
        torch.cuda.empty_cache()
        engine = phase_plane_engine(dev_info)
        torch.cuda.empty_cache()
    finally:
        if interval is None:
            os.environ.pop("MMLSPARK_TPU_TS_INTERVAL", None)
        else:
            os.environ["MMLSPARK_TPU_TS_INTERVAL"] = interval
        _plane_reset()
    return {"16a": front, "16b": engine}


def _phase15(params_np, single, dev_info):
    """Phases 15a-15c."""
    return {"15a": phase_decode_cb(params_np, single, dev_info),
            "15b": phase_failover(params_np, dev_info),
            "15c": phase_async_front(params_np, single, dev_info)}


def _phase14(dev_info, params_np):
    """Phases 14a-14d."""
    import torch
    a, b, launches = phase_onnx_bert_encoder(dev_info)
    nodes = phase_onnx_attention_nodes(dev_info)
    small = phase_onnx_vit_decoder(dev_info, params_np)
    torch.cuda.empty_cache()
    launches["14c"] = sum(r["k7_launches"] for r in nodes.values())
    return {"parity_f32": a, "bf16": b, "nodes": nodes, "vit_decoder": small,
            "k7_launches": launches}


def _phase10(params_np, dev_info, single, q8):
    """10a-10d; the NCCL world of one that 10b and 10c share is left
    before 10d spawns its two gloo ranks."""
    from mmlspark_tpu_torch.parallel import distributed
    from mmlspark_tpu_torch.parallel.mesh import make_mesh
    win = phase_window_kernels(dev_info)
    distributed.initialize(device="cuda")
    try:
        mesh = make_mesh({"tp": 1})
        mesh_par = phase_mesh_parity(params_np, single, mesh)
        serve = phase_mesh_serving(params_np, dev_info, mesh, q8,
                                   win["K5a"]["decode"]["write_ms"])
    finally:
        distributed.shutdown()
    tp2 = phase_tp2(dev_info, single[None])
    return win, mesh_par, serve, tp2


def _phase8(dev_info, X, y):
    """Phases 8a-8c."""
    hist_recs, sass = phase_hist_kernel(dev_info)
    parity = phase_tree_parity(X, y, dev_info)
    binning = phase_binning(X, dev_info)
    gbdt, b8c = phase_gbdt(X, y, dev_info, hist_recs)
    gbdt["binning"] = binning
    return hist_recs, sass, parity, gbdt, b8c


def _phase12(dev_info, X, y, b8c):
    """Phases 12a and 12b."""
    return (phase_estimator_higgs(X, y, dev_info, b8c),
            phase_multiclass(dev_info))


def _phase9(dev_info):
    """Phases 9a-9d; the kernels' 9a times at 9c's and 9d's own shapes
    give their shares."""
    import torch
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    flash_recs = phase_flash_kernels(dev_info)
    bert_np = init_transformer(_bert_cfg(torch.float32), seed=0)
    flash_parity = phase_flash_parity(bert_np, dev_info)
    infer_rec = flash_recs["infer bfloat16"]
    train_rec = flash_recs["train bfloat16"]
    infer = phase_flash_inference(bert_np, dev_info, infer_rec["K7"]["ms"])
    train, dec_mem = phase_flash_training(
        bert_np, dev_info,
        sum(train_rec[k]["ms"] for k in ("K7 stats", "K8a", "K8b")))
    return flash_recs, flash_parity, infer, train, dec_mem


def main(argv=()):
    sys.path.insert(0, HERE)
    try:
        import mmlspark_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the port package is not next to this script ({e})")
        return 2
    # "python3 chip_smoke.py 10": only phase 10 and what it needs (1, 2,
    # 4); "13", "15", "16" and "27": phases 1, 2, 4 and 13 (or 15, 16,
    # 27); "14",
    # "17", "18", "19", "20", "21", "22", "23", "24", "25" and "26": phases
    # 1, 2 and 14 (or 17, ..., 26);
    # "9":
    # phases 1, 2 and 9; "8":
    # phases 1, 2 and 8; "7": phases 1, 2, phase 3's K3/K4 cases and 7;
    # "3": phases 1, 2 and 3; a partial run prints no result and exits 3
    only = set(argv)
    modes = {"3", "7", "8", "9", "10", "11", "12", "13", "14", "15", "16",
             "17", "18", "19", "20", "21", "22", "23", "24", "25", "26",
             "27"}
    if not only <= modes:
        log(f"chip_smoke: unknown phases {sorted(only - modes)}; the "
            f"arguments are 3, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, "
            f"19, 20, 21, 22, 23, 24, 25, 26 and 27")
        return 2
    t_start = time.perf_counter()
    dev_info = phase_device()
    phase_build()
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    import torch
    params_np = init_transformer(_full_cfg(torch.float32), seed=0)
    if only:
        if "3" in only:
            phase_kernels(dev_info)
        if "7" in only:
            if "3" not in only:
                phase_read_kernels(dev_info)
            phase_read_sweep(params_np, dev_info)
        if only & {"8", "12"}:
            X, y = make_higgs_like(GBDT["rows"], GBDT["features"])
            if "8" in only:
                b8c = _phase8(dev_info, X, y)[-1]
            else:
                b8c = phase_gbdt(X, y, dev_info, {f"nodes{k}": {"ms": 0.0}
                                 for k in (1, 2, 4, 8, 16)})[1]
            if "12" in only:
                _phase12(dev_info, X, y, b8c)
            del X, y
        if "9" in only:
            _phase9(dev_info)
        if only & {"10", "13", "15", "16", "27"}:
            single = phase_parity(params_np)
        if "10" in only:
            _phase10(params_np, dev_info, single,
                     {"tok_per_s": None, "p50_tick_ms": None})
        if "13" in only:
            phase_spec_parity(params_np, single)
            phase_spec_bench(dev_info)
        if "11" in only:
            phase_onnx(dev_info)
        if "14" in only:
            _phase14(dev_info, params_np)
        if "15" in only:
            _phase15(params_np, single, dev_info)
        if "16" in only:
            _phase16(params_np, single, dev_info)
        if "17" in only:
            phase_image(dev_info)
        if "18" in only:
            _phase18(dev_info)
        if "19" in only:
            _phase19(dev_info)
        if "20" in only:
            _phase20(dev_info)
        if "21" in only:
            _phase21(dev_info)
        if "22" in only:
            _phase22(dev_info)
        if "23" in only:
            _phase23(dev_info)
        if "24" in only:
            _phase24(dev_info)
        if "25" in only:
            _phase25(params_np, dev_info)
        if "26" in only:
            _phase26(params_np, dev_info)
        if "27" in only:
            phase_mesh_dp(params_np, single, dev_info)
        log(f"[done] partial run of phases {sorted(only)}, "
            f"{time.perf_counter() - t_start:.1f} s; no result")
        return 3
    recs = phase_kernels(dev_info)
    single = phase_parity(params_np)
    serving = phase_serving(params_np, dev_info)
    q8 = phase_quant_serving(params_np, dev_info, "int8",
                             [32, 128, 384] * 3)
    f8 = phase_quant_serving(params_np, dev_info, "fp8", [32, 384])
    sweep = phase_read_sweep(params_np, dev_info)
    spec_a = phase_spec_parity(params_np, single)
    spec_b = phase_spec_bench(dev_info)
    p15 = _phase15(params_np, single, dev_info)
    p16 = _phase16(params_np, single, dev_info)
    X, y = make_higgs_like(GBDT["rows"], GBDT["features"])
    hist_recs, sass, parity, gbdt, b8c = _phase8(dev_info, X, y)
    est12a, multi12b = _phase12(dev_info, X, y, b8c)
    del X, y, b8c
    flash_recs, flash_parity, infer, train, dec_mem = _phase9(dev_info)
    infer_rec = flash_recs["infer bfloat16"]
    train_rec = flash_recs["train bfloat16"]
    win, mesh_par, serve, tp2 = _phase10(params_np, dev_info, single, q8)
    p27 = phase_mesh_dp(params_np, single, dev_info)
    bert14 = _phase14(dev_info, params_np)
    p25 = _phase25(params_np, dev_info)
    p26 = _phase26(params_np, dev_info)
    del params_np
    phase_onnx(dev_info)
    phase_image(dev_info)
    p18 = _phase18(dev_info)
    p19 = _phase19(dev_info)
    p20 = _phase20(dev_info)
    p21 = _phase21(dev_info, hist_recs)
    p22 = _phase22(dev_info)
    _phase23(dev_info)
    p24 = _phase24(dev_info)
    k6_19 = {**p19["19a"]["k6_launches"], **p19["19b"]["k6_launches"]}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    src = "mmlspark_tpu_torch/csrc/paged_attention.cu"
    ref = "mmlspark_tpu/ops/paged_attention.py"
    # K1/K2's decode launches are the split body's (``_window_split``
    # asserts it), so they are its ``launches_split``; their speculative
    # verify windows are 13a's (f32: the FMA body) and 13b's (bf16: the
    # tensor-core body)
    k1_fma = spec_a["f32"]["launches_spec_verify"] + \
        spec_a["perfect_draft"]["launches_spec_verify"]
    k2_fma = sum(spec_a[n]["launches_spec_verify"] for n in ("int8", "fp8"))
    k1_mma = spec_b["spec"]["launches_spec_verify"]
    # phase 15's paths, each counted from zero: 15a's f32 parity engine and
    # its two bf16 runs, 15b's cold and warm restores (K2 on int8 and fp8
    # pages), 15c's bf16 async front
    p15a, p15b = p15["15a"], p15["15b"]
    k_15a = {"f32_parity": p15a["f32_parity"]["launches"]["k1"],
             "prefill_ahead_32": p15a["prefill_ahead"]["launches"]["k1"],
             "prefill_ahead_0": p15a["no_prefill_ahead"]["launches"]["k1"]}
    k_15b = {f"{name} {mode}": p15b[name][f"launches_{mode}"]
             for name in p15b for mode in ("cold", "warm")}
    k1_15b = {k: v["k1"] for k, v in k_15b.items() if v["k1"]}
    k2_15b = {k: v["k2"] for k, v in k_15b.items() if v["k2"]}
    # phase 20's K1 launches: 20b's verify windows (W = gamma + 1) of the
    # speculative reference loop, FMA in f32 and tensor-core in bf16
    k1_20 = {"fma": p20["20b"]["k1_launches_fma"],
             "mma": p20["20b"]["k1_launches_mma"]}
    k1_25 = p25["25a"]["launches"]["k1"]
    # phase 26's failover paths, each counted from zero after the hand-off:
    # 26a's adopting decoders (bf16 pages: K1; int8: K2; decode only, the
    # split body) and 26b's cold restore (f32: re-prefill chunks on the
    # FMA body, then decode on the split body)
    l26 = p26["launches"]
    k1_26 = {"26a bf16": l26["26a bf16"], "26b f32": l26["26b f32"]}
    k2_26 = {"26a int8": l26["26a int8"]}
    # phase 27's K5 launches on its four ranks, each counted from zero
    k5a_27 = sum(v["launches"] for runs in p27["k5_by_rank"].values()
                 for k, v in runs.items() if k != "27b int8")
    k5b_27 = sum(runs["27b int8"]["launches"]
                 for runs in p27["k5_by_rank"].values())
    kernels = [
        {"name": "paged_attention_window", "route": "cuda", "source": src,
         "replaces": f"{ref}:226",
         "launches": (serving["k1_launches"] + sum(k1_20.values()) + k1_25
                      + sum(v["k1"] for v in k1_26.values())),
         "launches_serving_5": serving["k1_launches"],
         "launches_cluster_failover_26": k1_26, "cluster_26": p26,
         "launches_http_generation_25a": p25["25a"]["launches"],
         "http_services_25": p25,
         "launches_generation_20b": k1_20, "generation_20": p20,
         "launches_decode": serving["k1_launches_decode"],
         "launches_extend": serving["k1_launches_extend"],
         "launches_split": serving["k1_launches_decode"],
         "launches_spec_verify": k1_fma + k1_mma,
         "launches_spec_verify_mma": k1_mma,
         "launches_spec_verify_fma": k1_fma,
         "launches_decode_cb_15a": k_15a,
         "launches_failover_15b": k1_15b,
         "launches_async_front_15c": p15["15c"]["launches"]["k1"],
         "launches_plane_front_16a": p16["16a"]["launches"]["k1"],
         "plane_front_16a": p16["16a"],
         "spec_bench_13b": spec_b, "spec_parity_13a": spec_a,
         "phase_15": p15,
         **{k: recs["K1"]["decode"][k] for k in keys}, **recs["K1"]},
        {"name": "paged_attention_window (k_scale/v_scale)", "route": "cuda",
         "source": src, "replaces": f"{ref}:404",
         "launches": (q8["k2_launches"]
                      + sum(v["k2"] for v in k2_26.values())),
         "launches_fp8_run": f8["k2_launches"],
         "launches_cluster_failover_26": k2_26,
         "launches_decode": q8["k2_launches_decode"],
         "launches_extend": q8["k2_launches_extend"],
         "launches_fp8_run_decode": f8["k2_launches_decode"],
         "launches_fp8_run_extend": f8["k2_launches_extend"],
         "launches_split": q8["k2_launches_decode"],
         "launches_fp8_run_split": f8["k2_launches_decode"],
         "launches_spec_verify": k2_fma, "launches_spec_verify_mma": 0,
         "launches_spec_verify_fma": k2_fma,
         "launches_failover_15b": k2_15b,
         **{k: recs["K2"]["int8 decode"][k] for k in keys}, **recs["K2"]},
        {"name": "paged_attention", "route": "cuda", "source": src,
         "replaces": f"{ref}:195", "launches": sweep["k3_launches"],
         "launches_split": sweep["k3_launches_split"],
         **{k: recs["K3"]["read"][k] for k in keys}, **recs["K3"]},
        {"name": "paged_attention (k_scale/v_scale)", "route": "cuda",
         "source": src, "replaces": f"{ref}:356",
         "launches": sweep["k4_launches"],
         "launches_split": sweep["k4_launches_split"],
         **{k: recs["K4"]["int8 read"][k] for k in keys}, **recs["K4"]},
        {"name": "paged_attention_window (mesh=)", "route": "cuda",
         "source": src, "replaces": f"{ref}:297",
         "launches": serve["mesh"]["k5a_launches"] + k5a_27,
         "launches_dp2xtp2_27": {who: {k: v for k, v in runs.items()
                                       if k != "27b int8"}
                                 for who, runs in p27["k5_by_rank"].items()},
         "mesh_dp2xtp2_27": p27,
         "launches_decode": serve["mesh"]["k5a_launches_decode"],
         "launches_extend": serve["mesh"]["k5a_launches_extend"],
         "launches_mesh_parity_f32": mesh_par["f32"]["k5a"],
         "launches_mesh_parity_f32_split": mesh_par["f32"]["split"],
         "launches_tp2_per_rank": tp2["k5a_launches_per_rank"],
         "launches_tp2_split_per_rank": tp2["k5a_launches_split_per_rank"],
         **{k: win["K5a"]["decode"][k] for k in keys}, **win["K5a"]},
        {"name": "paged_attention_window (mesh=, k_scale/v_scale)",
         "route": "cuda", "source": src, "replaces": f"{ref}:461",
         "launches": (mesh_par["int8"]["k5b"] + mesh_par["fp8"]["k5b"]
                      + k5b_27),
         "launches_dp2xtp2_int8_27b": {
             who: runs["27b int8"] for who, runs in p27["k5_by_rank"].items()},
         "launches_int8_run": mesh_par["int8"]["k5b"],
         "launches_fp8_run": mesh_par["fp8"]["k5b"],
         "launches_split": (mesh_par["int8"]["split"]
                            + mesh_par["fp8"]["split"]),
         **{k: win["K5b"]["int8 decode"][k] for k in keys}, **win["K5b"]},
        {"name": "level_histogram", "route": "cuda",
         "source": "mmlspark_tpu_torch/csrc/histogram.cu",
         "replaces": "mmlspark_tpu/ops/pallas_kernels.py:124",
         "launches": (gbdt["k6_launches"] + est12a["k6_launches"]
                      + multi12b["k6_launches"] + sum(k6_19.values())
                      + sum(p21["k6_launches"].values())
                      + sum(p22["k6_launches"].values())
                      + sum(p24["k6_launches"].values())),
         "launches_train_8c": gbdt["k6_launches"],
         "launches_estimator_12a": est12a["k6_launches"],
         "launches_multiclass_12b": multi12b["k6_launches"],
         "launches_afterfit_19": k6_19,
         "launches_trainer_21": p21["k6_launches"],
         "launches_rank_regularizers_checkpoints_22": p22["k6_launches"],
         "launches_automl_24": p24["k6_launches"],
         "ranker_22a": {label: {k: p22["22a"]["k6"][label][k]
                                for k in keys + ("shape",)}
                        for label in p22["22a"]["k6"]},
         "bundled_21d": {label: {k: hist_recs[label][k] for k in keys}
                         for label, *_ in bundled_hist_cases()},
         **{k: hist_recs["nodes16"][k] for k in keys},
         "class_batched": {label: {k: hist_recs[label][k]
                                   for k in keys + ("singles_ms",)}
                           for label, *_ in hist_class_cases()},
         "max_abs_err_all_cases": max(r["max_abs_err"]
                                      for r in hist_recs.values()),
         "cases": hist_recs, "sass_shared_atomics": sass,
         "bound_finding": "shared-memory atomics (each f32 add a CAS "
                          "loop), then load latency: PERF.md §6, K6's "
                          "step 1",
         "tree_parity": parity,
         "sec_per_iter": gbdt["sec_per_iter"],
         "share_of_iter": gbdt["k6_share_of_iter"],
         "estimator_12a": est12a, "multiclass_12b": multi12b,
         "afterfit_19": p19, "trainer_21": p21,
         "ranker_regularizers_checkpoints_22": {
             k: p22[k] for k in ("22a", "22b", "22c")}}]
    fsrc = "mmlspark_tpu_torch/csrc/flash_attention.cu"
    fref = "mmlspark_tpu/ops/flash_attention.py"
    sdpa = "F.scaled_dot_product_attention"
    # headline times at the main paths' shapes: K7 at 9c's inference
    # (without stats), K8a/K8b at 9d's training
    main_rec = {"K7": infer_rec, "K8a": train_rec, "K8b": train_rec}
    k7_onnx = sum(bert14["k7_launches"].values())
    k7_engine = p16["16b"]["k7_launches"]
    k7_quant = {k: p18["18b"][k]["k7_launches"] for k in ("bf16", "int8")}
    # phase 22's ONNX fine-tuning: the parity step, 22d's and 22e's fits
    fl22 = p22["flash_launches"]
    k22 = {k: sum(v[k] for v in fl22.values()) for k in ("k7", "k8a", "k8b")}
    extras = {
        "K7": {"with_stats": {k: train_rec["K7 stats"][k] for k in keys},
               "launches_inference": infer["k7_launches"],
               "launches_training": train["k7_launches"],
               "launches_onnx": k7_onnx,
               "launches_onnx_by_run": bert14["k7_launches"],
               "launches_serving_engine_16b": k7_engine,
               "launches_generation_20": {
                   "train_20a": p20["20a"]["k7_launches"],
                   "generate_20d": p20["20d"]["k7_launches"]},
               "launches_quant_bert_18b": k7_quant,
               "launches_onnx_finetune_22": {k: v["k7"]
                                             for k, v in fl22.items()},
               "onnx_finetune_22": {k: p22[k] for k in ("22d", "22e")},
               "serving_engine_16b": p16["16b"],
               "onnx_infer_14b": bert14["bf16"]["k7"],
               "library_call": sdpa, "model_parity": flash_parity,
               "inference": infer},
        "K8a": {"library_call": f"autograd backward of {sdpa} (dQ, dK "
                                f"and dV together)",
                "launches_generation_train_20a": p20["20a"]["k8a_launches"],
                "launches_onnx_finetune_22": {k: v["k8a"]
                                              for k, v in fl22.items()},
                "training": train, "decoder_memory": dec_mem},
        "K8b": {"library_call": f"autograd backward of {sdpa} (dQ, dK "
                                f"and dV together)",
                "launches_generation_train_20a": p20["20a"]["k8b_launches"],
                "launches_onnx_finetune_22": {k: v["k8b"]
                                              for k, v in fl22.items()}}}
    for key, name, line, launches in (
            ("K7", "flash_attention", 64,
             infer["k7_launches"] + train["k7_launches"] + k7_onnx
             + k7_engine + sum(k7_quant.values())
             + p20["20a"]["k7_launches"] + p20["20d"]["k7_launches"]
             + k22["k7"]),
            ("K8a", "flash_attention backward (dK, dV)", 230,
             train["k8a_launches"] + p20["20a"]["k8a_launches"]
             + k22["k8a"]),
            ("K8b", "flash_attention backward (dQ)", 270,
             train["k8b_launches"] + p20["20a"]["k8b_launches"]
             + k22["k8b"])):
        kernels.append({
            "name": name, "route": "cuda", "source": fsrc,
            "replaces": f"{fref}:{line}", "launches": launches,
            **{k: main_rec[key][key][k] for k in keys},
            "shape": main_rec[key][key]["shape"],
            "max_abs_err_all_cases": max(r[key]["max_abs_err"]
                                         for r in flash_recs.values()),
            "cases": {label: {k: flash_recs[f"{label} bfloat16"][key][k]
                              for k in keys + ("shape",)}
                      for label in FLASH_TIMED},
            **extras[key]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(dev_info["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.exit(code)
