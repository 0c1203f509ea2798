#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or a few each, exit code non-zero on any failure:
  1. device:  the card's name and power limit (nvidia-smi).
  2. build:   nvcc of every ops/csrc/*.cu, in parallel, into build/kernels/.
  3. kernels: each kernel against its plain PyTorch version on the card, at
              serving shapes and at D=1536 for the GEGLU, in float32 and
              bfloat16, and the attention at the flat eval's
              [1, 8, 131072, 512] in float32, with the time of the kernel, of
              the plain version, of one PyTorch library call that computes
              the same function (a yardstick the port never calls), the least
              time the card could take (the bound) and the kernel's share of
              it. Each time is taken twice (ops/timing.py): as calls back to
              back, host costs included (ms, plain_ms, library_ms), and as
              the device time of calls replayed from a CUDA graph
              (device_ms, plain_device_ms, library_device_ms). A bfloat16 GEGLU
              is held to its tolerance beyond the one-unit roundings of gated
              values that lie at a bfloat16 tie (geglu_tie_allowance).
  4. serve:   a full-width latent tower (D=1024, 64 latents, 8 heads x 512)
              with random weights from a numpy seed, saved as a state_dict,
              and a 65,238 x 1024 news table (MIND-small's news count) saved
              as an id-keyed dump, loaded through cli.serve.build_ranker;
              rank, retrieve(k=10), a rank_batch of 64 MIND-like requests and
              one HTTP POST /rank, with every launch count set to 0 just
              before and read just after. Every kernel must have launched;
              4 requests must match the same ranker built on the CPU.
  5. main path: each kernel against its plain version again, at every shape
              the served path launched it at (float32), with the times, the
              bound and the share of bound per shape and summed over those
              launches.
  6. flat eval: FlatEvalPlan.score and .metrics (with a DeviceMetricsPlan)
              over bench.py's MIND-small-scale workload (50,000 rows;
              build_workload copied here) at full width, in float32 and in bfloat16
              as bench.py runs it; the chunk estimate_flat_chunk picks, the
              peak memory, each kernel's launches and shapes (counts set to
              0 just before one metrics run and read just after),
              impressions/s of three timed runs of each, a profiled metrics
              run and its host syncs. Checks: 1 both kernels launched; 2
              about 64 rows centred on the float32 chunk boundaries, some
              straddling two chunks, match the same plan on the CPU (1e-4);
              3 score runs are bit-identical; 4 metrics equal
              DeviceMetricsPlan.compute of the scores (1e-6); 5 the same
              rows match the tower's padded, masked call (1e-5); 6 bfloat16
              within a norm-relative 3e-2 of
              float32. Then each kernel against its plain version at every
              shape the flat eval launched it at, as in phase 5 (the plain
              versions on pieces of at most PIECE_ROWS rows).
  7. train:   training at full width in float32. 7a: one flat batch at B=64
              (T = 2,048): the margin and InfoNCE losses and every
              parameter's gradient on the card against the CPU from the same
              weights (1e-5 and a norm-relative 1e-4), both kernels launched
              forward, and two runs of 5 steps from one state giving the
              same parameter bits. 7b: bench.py's worst-case batch (B=2048,
              T = 65,536; flat_inputs copied here), margin and InfoNCE (K=5):
              3 warm-up and 5 timed steps with the loss fetched every step,
              ms/step, pairs/s, the peak memory, the device time by part (the
              kernels' forward, cuBLAS forward, the plain backward, the
              optimizer), a profiled step and its host syncs (want 1), with
              the launch counts set to 0 just before the timed steps and
              read just after. 7c: TowerTrainer (flat_train, flat_eval,
              device_metrics) on bench.py's trained-metrics fixture against
              the same trainer on the CPU, epoch by epoch, and bench.py's AUC
              gate of 0.58; then at full width, 2 epochs on 20,000 train
              and 5,000 val rows of the learnable fixture and 1 epoch on
              half of bench.py's MIND-small-scale rows (25,000 train, 5,000
              val):
              pairs/s end to end, the steps by T, the eval's time, the
              metrics. Then each kernel against its
              plain version at every shape the timed train steps launched it
              at, as in phase 5.
  8. padded: the other towers and the padded path at full width (float32,
              TF32 off, unless bfloat16 is named), each part printing JSON
              lines ({"part": ...}). 8a: final_attention (hidden 4096),
              transformer (as_built False and True) and latent forward on
              [64, 600] MIND-like histories with an all-pad row: the card
              against the CPU on four rows (1e-4 of the output's scale),
              bfloat16 compute against float32 (norm-relative 3e-2), all
              finite. 8b: score_all_impressions(flat_tokens=False) over
              build_workload per tower, batches from estimate_tower_batch:
              impressions/s, peak memory against tower_activation_bytes,
              the busy share of a profiled run, the padding share; the
              latent tower's padded scores against its flat eval capped at
              600 (1e-5), its launches counted. 8c.1: one padded step per
              tower at B=64 against the CPU (1e-5, norm-relative 1e-4 for
              the whole gradient and for each parameter; final_attention's
              ReLU sign flips masked out, zero-gradient leaves under 1e-6 in
              norm; dropout off), two 5-step runs with dropout on
              bit-identical.
              8c.2: 5 timed margin steps per tower at B=512, flat_inputs's
              histories padded to each batch's bucket: ms/step, pairs/s,
              peak memory, device time by part, one host sync a step (the
              latent tower's launches counted). 8c.3: TowerTrainer(
              flat_train=False, flat_eval=False) on bench.py's fixture (d=64)
              for final_attention and transformer against the CPU. 8c.4: one
              full-width epoch per tower on the learnable fixture: pairs/s,
              a fixed train batch's loss falling, val metrics. 8d:
              ClassificationTrainer then JointTowerTrainer (a blend over its
              baseline, a reducer) on the d=64 fixture against the CPU, and
              one full-width epoch each. 8e: build_ranker with
              final_attention and transformer over phase 4's requests:
              requests/s, the CPU ranker's order and scores within 1e-5.
              Then each kernel against its plain version at every shape the
              padded eval and the timed padded steps launched it at.
  9. e2e:     the end-to-end token-level path (config[2]) at full width in
              float32, TF32 off: a one-layer TokenAttentionPool (8 heads, MLP
              3,072) and run_config2's latent tower (16 latents, 8 heads x
              256, GEGLU 4,096), one JSON line a part. 9a: a token store of
              65,238 news (e2e_bench.py's rule: lengths geometric with mean
              24 clipped to 2-64, states N(0, 0.3^2)), its size, the memory
              model's verdict and its upload. 9b: one batch at M=256, T=64,
              B=64, L=64, dropout off: margin and InfoNCE's loss and every
              gradient of both modules on the card against the CPU (1e-5,
              norm-relative 1e-4), both kernels launched; with dropout on, 5
              steps on the resident store and on the streamed block give the
              same bits, and so do two resident runs. 9c: e2e_bench.py's
              batch (M=2048, T=64, B=1024, L=64), margin and InfoNCE (K=5),
              each on the resident store and streamed: 3 warm-up and 5 timed
              steps, the loss fetched every step; ms/step, pairs/s, bytes to
              the card a step, peak memory, the device time by part, host
              syncs a step. 9d: materialize_from_token_store over the whole
              store resident and over its first 16,384 news streamed: news/s,
              the batch the memory model picks, the routes within 1e-6. 9e:
              configs.run_config2 at dim=1024 with its published defaults
              (batch 32, one epoch) on 256 of build_workload's rows over the
              store's news: pairs/s, the steps by M, T and L, the
              materialize time, the fused eval's
              impressions/s and metrics (finite, in [0, 1]). Then each kernel
              against its plain version at every shape the timed steps, 9e's
              epoch and 9e's eval launched it at.
 10. encoder: the news encoder from cli.common.build_encoder (seeded
              weights drawn on the card, HashTokenizer), one JSON line a
              part. 10a: e5-large at full width and depth (24 layers,
              D=1,024, 16 heads, FFN 4,096, vocab 250,002) on 16 news of
              mixed lengths, the card against the CPU (float32 norm-relative
              1e-4; the card in bfloat16 within 3e-2; unit norms), and the
              bucketed encode against the fixed-width one on the card. 10b:
              encode_query_and_passage over 32,768 MIND-like title news
              (15-35 tokens) at max_length 128, buckets and the memory
              model's batch, bfloat16: the host's tokenisation apart, the
              passage and query encodes timed apart (news/s, real tokens/s),
              padded tokens a real one, one profiled bucket's busy share, the
              peak memory against encoder_activation_bytes. 10c:
              build_token_store of the first 16,384 passages in float16 into
              a directory (news/s, GB written; 4,096 in RAM and to disk
              apart), 32 rows about the bucket edge against hidden_states,
              then run_config2 for one epoch on that store, as 9e; the
              directory is deleted. 10d: NV-Embed's published
              widths (Mistral-7B backbone cut to 2 of 32 layers, printed as
              reduced; the head of 512 latents and 8 heads x 4,096 whole):
              8 news card against CPU as 10a, then 4,096 news through
              encode_corpus_bucketed at batch 128 (news/s) with both
              kernels' launches counted. Then each kernel against its plain
              version at every shape the head launched it at.
 11. pipeline: the user's path from MIND's raw TSVs through the CLIs'
              main(argv), in a temporary directory deleted afterwards, one
              JSON line a part. 11a: raw TSVs of MINDsmall_train and
              MINDsmall_dev (16,384 news with 10b's titles; 16,384 and 8,192
              rows by build_workload's rule, reduced from MIND-small's
              65,238 news and 156,965 / 73,152 rows), nrtorch-ingest on
              each, load_dataset and the compile timed. 11b:
              nrtorch-save-emb of both splits (e5-large, bfloat16, the
              memory model's batch): news/s, the dump's size,
              unit norms. 11c: nrtorch-train --tower latent at D = 1,024,
              one epoch each, batch 512, with every launch count set to 0
              just before and read just after: each step's host seconds, the
              tower epoch's pairs/s, one profiled step's busy share, the peak
              memory, the metrics; then the same command again, every step
              from the cache and no device work. 11d: nrtorch-eval --ckpt of
              the best checkpoint against FlatEvalPlan + DeviceMetricsPlan
              from it (1e-5), and nrtorch-serve --ckpt in its own process
              answering a POST /rank. 11e: LoadEmbedding -> Classification
              -> Attention on 128 train and 64 dev rows, full width, on the
              card and on the CPU (metrics and weights, norm-relative 1e-4).
              11f: nrtorch-reproduce --synthetic --with-e2e with e5-large on
              write_synthetic_mind's fixture (three finite CONFIG_ROWs),
              then nrtorch-train-e2e at --dim 1024. Then each kernel against
              its plain version at every shape 11c launched it at.
 12. mesh:    two ranks spawned on the one card (parallel.mesh.launch),
              joined over gloo with CUDA tensors (NCCL refuses two ranks on
              one GPU), full width, float32, TF32 off, one JSON line a part.
              12a: NCCL's world of one in this process and the two gloo
              ranks: backend, world, mesh shapes, a 64 MB all_reduce timed
              and exact. 12b: mesh (2, 1), 7b's global batch (B = 2,048,
              T = 65,536), margin and InfoNCE: 5 data-parallel steps, each
              against one rank's loss (1e-6) and gradient (norm-relative
              1e-5) at the same weights, the ranks' weights equal to the bit,
              then 3 timed steps (ms a step, pairs/s); the padded step the
              same at B = 512 on 8c.2's batches. 12c: mesh (1, 2), the
              65,238 x 1024 table row-sharded: each rank's shard, the sharded
              gather equal to the plain one to the bit, 5 steps as 12b. 12d:
              ShardedFlatEvalPlan + ShardedMetricsPlan over phase 6's
              workload and table: the metrics within 1e-6 of phase 6's
              float32 ones, impressions/s, each rank's token share. 12e:
              configs.run_config3 on mesh (1, 2) over 128 of
              build_workload's rows (reduced), one epoch, with the launch
              counts set to 0 just before and read just after on each rank,
              against TowerTrainer without a mesh (metrics 1e-5, loss
              relative 1e-4); then nrtorch-train --mesh 2,1 under torchrun
              on write_synthetic_mind's fixture at --dim 1024 against the
              same command on one rank (dev metrics 1e-5). 12f: 11a's 16,384
              train rows compiled by the native extension and by numpy,
              equal, both timed. Then each kernel against its plain version
              at every shape run_config3 launched it at on the ranks.
 13. mesh2:   multi-GPU part 2 on two gloo ranks sharing the card (NCCL
              refuses two ranks on one GPU), full width, float32 unless
              named, one JSON line a part. 13a: phase 9's store rebuilt on
              each rank from 9a's generator state; half of 9c's batch (M =
              1,024, T = 64, B = 512, L = 64, margin) on meshes (2, 1) and
              (1, 2) from the streamed block, the store replicated on each
              rank and the ShardedStore (3.01 GB a rank): 1 step each
              against one rank's loss (1e-6) and gradient (norm-relative
              1e-5), 1 timed (ms a step, pairs/s, the bytes a step's
              sharded gather moves), the ranks' weights equal to the bit;
              materialize_from_token_store_mesh over the store's first
              8,192 news, replicated and sharded, against 9d within 1e-5
              (news/s); EndToEndTrainer(mesh=) on 64 rows drawn as 9e's
              (batch 256, dropout off,
              one epoch and its fused eval) against one rank. 13b:
              make_sharded_encode_fn with e5-large (bfloat16) over 8,192 of
              phase 10's titles against one rank (phase 10's bfloat16
              tolerance), then configs.run_config4 on mesh (1, 2) over 12e's
              rows with train_cfg=None and MESH_TRAIN against run_config0 /
              TowerTrainer on one rank. 13c: e5-large in float32 under
              shard_encoder_params_tp on mesh (1, 2): split leaves, weights
              and forward peak per rank against one rank's, within 1e-5.
              13d: the latent tower over [512, 512] histories with the
              sequence split over mesh (1, 2) against the padded tower
              within 1e-5. 13e: build_ranker(mesh=) over phase 4's dump on
              mesh (1, 2), rank 0 answering phase 4's requests (scores 1e-5,
              ids equal, requests/s) while rank 1 follows, then
              nrtorch-serve --mesh 1,2 --dist-backend gloo --stdio under
              torchrun answering one request. Then each kernel against its
              plain version at every shape the ranks' mesh path launched it
              at.
 14. mixed:   (run after phase 11, before the mesh phases 12-13) mixed
              precision, towers in bfloat16 or float16 (parameters
              float32), one JSON line a part. 14a: both kernels in float16
              against their plain versions at phase 3's shapes and at the
              train paths' (timed as in phase 3), and each Function in
              bfloat16 and float16 at 64 rows, output and gradients on the
              card against the CPU (a norm-relative unit of the type). 14b:
              7b's batch in bfloat16, margin and InfoNCE, 5 timed steps
              (ms, pairs/s, peak memory against the memory model, device
              time by part, the GEGLU backward's GEMMs timed alone) beside
              7b's float32 figures (each split's optimizer part on CUDA
              events); the card's gradients, bfloat16 at B = 16 and float16
              at B = 4 (the tokens trimmed to the live ones: the CPU of the
              card's host multiplies float16 slowly), against the CPU's
              float32 ones and its own in the same type with
              tests/test_torch_mixed_precision.py's criteria (loss
              1e-3; every leaf |g - g32| <= 1.5 |g_cpu - g32| + 5e-3 |g32|
              and |g - g_cpu| <= 0.15 |g_cpu|, norms). 14c: 8c.2's padded
              steps for the three towers in bfloat16 and the latent tower in
              float16, beside 8c.2's; the latent step's gradients (32
              clicks), bfloat16 at 8c.1's B = 64 and float16 at B = 4, held
              as 14b's. 14d (run inside phase 9, while the store is
              resident): 9c's resident steps in bfloat16 beside 9c's; the
              resident step's gradients at M = 64, B = 16, L = 64, margin
              and InfoNCE, held as 14b's. 14e: TowerTrainer on 7c's learnable
              fixture in bfloat16, 2 epochs, beside 7c's (the loss falls,
              parameters stay float32). 14f: build_ranker with a float16 latent
              tower over phase 4's dump and requests, 4 against the CPU's
              float16 ranker (scores norm-relative 3e-2, the CPU's order up to
              near-ties). Then each kernel against its plain version at every
              shape the bfloat16 paths (14b-14e) and the float16 ones (14c's
              latent step, 14f) launched it at.
The line before the last holds the kernels' record as JSON, one entry per
kernel and path ("path": "serve" from phase 5, "flat_eval" from phase 6,
"train" from phase 7, "padded_eval" and "padded_train" from phase 8,
"e2e_train" and "e2e_eval" from phase 9, "encoder" from phase 10,
"pipeline" from phase 11, "mesh" from phase 12, "mesh2" from phase 13,
"train_bfloat16" and "train_float16" from phase 14);
phase 1's line holds the card's
name and power limit as nvidia-smi gives them; the last line is
{"ok": true, "device": {...}}.
Without CUDA it exits 2 and prints no result; any failed check raises and
exits 1.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from news_recommendation_project_v2_torch import configs as configs_module  # noqa: E402
from news_recommendation_project_v2_torch.cli.serve import build_ranker, make_server  # noqa: E402
from news_recommendation_project_v2_torch.cli.common import build_encoder  # noqa: E402
from news_recommendation_project_v2_torch.config import (  # noqa: E402
    HISTORY_BUCKETS,
    QUERY_INSTRUCTION,
    EncoderConfig,
    MeshConfig,
    NewsDataset,
    TowerConfig,
    TrainConfig,
    bucket_for,
    tower_kwargs_for_dim,
)
from news_recommendation_project_v2_torch.data.compiler import CompiledBehaviors, compile_behaviors, compile_native  # noqa: E402
from news_recommendation_project_v2_torch.data.synthetic import (  # noqa: E402
    align_embeddings,
    synthetic_learnable_behaviors,
)
from news_recommendation_project_v2_torch.data.grouping import gather_end_aligned, lengths_to_offsets  # noqa: E402
from news_recommendation_project_v2_torch.device import resolve_device  # noqa: E402
from news_recommendation_project_v2_torch.eval.device_metrics import DeviceMetricsPlan  # noqa: E402
from news_recommendation_project_v2_torch.models import TokenAttentionPool, build_tower  # noqa: E402
from news_recommendation_project_v2_torch.models.convert import (  # noqa: E402
    classification_head_state_dict_from_jax,
    e2e_state_dict_from_jax,
    latent_state_dict_from_jax,
    random_classification_head_params,
    random_e2e_params,
    random_latent_params,
    random_reducing_params,
    random_tower_params,
    random_weighted_sum_params,
    reducing_state_dict_from_jax,
    tower_state_dict_from_jax,
    weighted_sum_state_dict_from_jax,
)
from news_recommendation_project_v2_torch.models.layers import dense  # noqa: E402
from news_recommendation_project_v2_torch.models.news_encoder import NewsEncoder, encoder_config_from_hf  # noqa: E402
from news_recommendation_project_v2_torch.models.towers import (  # noqa: E402
    ClassificationHead,
    ReducingModel,
    WeightedSumModel,
)
from news_recommendation_project_v2_torch.ops import _build  # noqa: E402
from news_recommendation_project_v2_torch.ops.encode import (  # noqa: E402
    TOKEN_BUCKETS,
    TokenStore,
    build_token_store,
    encode_corpus,
    encode_corpus_bucketed,
    encode_query_and_passage,
    gathered_token_states,
    materialize_from_token_store,
    save_embeddings,
)
from news_recommendation_project_v2_torch.ops.geglu import geglu, reference_geglu  # noqa: E402
from news_recommendation_project_v2_torch.ops.latent_attention import (  # noqa: E402
    latent_attention,
    reference_attention,
)
from news_recommendation_project_v2_torch.ops.scoring import (  # noqa: E402
    FlatEvalPlan,
    _bucket_plan,
    score_all_impressions,
)
from news_recommendation_project_v2_torch.ops.timing import count_syncs, cuda_ms, graph_ms  # noqa: E402
from news_recommendation_project_v2_torch.train.step import (  # noqa: E402
    apply_step,
    e2e_infonce_loss,
    e2e_infonce_loss_gathered,
    e2e_margin_loss,
    e2e_margin_loss_gathered,
    flat_infonce_loss,
    flat_infonce_step,
    flat_margin_loss,
    flat_margin_step,
    padded_infonce_loss,
    padded_margin_loss,
)
from news_recommendation_project_v2_torch.train.trainer import (  # noqa: E402
    ClassificationTrainer,
    EndToEndTrainer,
    JointTowerTrainer,
    TowerTrainer,
    _upload_states,
    make_optimizer,
)
from news_recommendation_project_v2_torch.utils.memory import (  # noqa: E402
    TRAIN_MULTIPLIER,
    encoder_activation_bytes,
    estimate_encoder_batch,
    estimate_flat_chunk,
    estimate_token_attention_batch,
    estimate_tower_batch,
    fits_device_token_store,
    flat_token_bytes,
    tower_activation_bytes,
)

NUM_NEWS, DIM = 65_238, 1024
N_REQUESTS = 64
FLAT_ROWS = 50_000  # with-history impression rows of the flat eval, as in bench.py
SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet, dense) and device-memory
# bandwidth. bfloat16 and float16 on the tensor cores. float32: the card computes
# float32-accurate products fastest as 3xTF32 on the tensor cores (three TF32
# products each, 495 / 3 = 165 TFLOP/s), not on the CUDA cores (67 TFLOP/s),
# so 165 is the least time the work can take, whichever kernel does it.
PEAK_FLOPS = {torch.float32: 165e12, torch.bfloat16: 989e12, torch.float16: 989e12}
PEAK_BYTES = 3.35e12
# Tolerances of kernel vs plain version on the same inputs. Both compute
# float32-accurate products (the GEGLU as 3xTF32) summed in float32, and
# differ in summation order: a bfloat16 output may then round one unit apart
# (2^-8 relative), a float16 output one unit of 2^-10 at its binade (2^-11
# relative), a float32 GEGLU sums up to 6,144 + 1,536 products.
TOL = {
    ("latent_attention", torch.float32): 1e-5,
    ("latent_attention", torch.bfloat16): 2**-8 * 4.0,
    ("latent_attention", torch.float16): 2**-10 * 4.0,
    ("geglu", torch.float32): 1e-4,
    ("geglu", torch.bfloat16): 1e-3,
    ("geglu", torch.float16): 2.5e-4,
}
def log(msg: str) -> None:
    print(msg, flush=True)


def since(t_start: float) -> str:
    return f"[{time.perf_counter() - t_start:.1f}s]"


def attention_inputs(shape, dtype, gen):
    b, h, l, n, dh = shape
    return tuple(
        torch.randn(*s, device="cuda", generator=gen).to(dtype)
        for s in ((b, h, l, dh), (h, n, dh), (h, n, dh))
    )


def attention_work(shape, es: int) -> tuple[float, float]:
    """(operations, bytes): q read and o written once, k and v read once."""
    b, h, l, n, dh = shape
    return 4.0 * b * h * l * n * dh, (2.0 * b * h * l * dh + 2.0 * h * n * dh) * es


def attention_library(q, k, v):
    b, h, _, dh = q.shape
    n = k.shape[1]
    return F.scaled_dot_product_attention(q, k.expand(b, h, n, dh), v.expand(b, h, n, dh))


def geglu_inputs(shape, dtype, gen):
    c, d, f = shape
    scales = ((c, d), 1.0), ((2 * f, d), d**-0.5), ((2 * f,), 0.02), ((d, f), f**-0.5), ((d,), 0.02)
    return tuple(
        (torch.randn(*s, device="cuda", generator=gen) * sc).to(dtype) for s, sc in scales
    )


def geglu_work(shape, es: int) -> tuple[float, float]:
    """(operations, bytes): x, both weights and biases read once, the
    float32 y written once."""
    c, d, f = shape
    return 6.0 * c * d * f, (c * d + 3.0 * d * f + 2.0 * f + d) * es + 4.0 * c * d


# A float32 gated product u within this relative distance of a bfloat16 (or
# float16) rounding tie may round either way in two float32-accurate computations:
# the plain version's own float32 sums differ from exact ones by about 2^-20.
TIE = 2.0**-18


def geglu_tie_allowance(x, w_in, b_in, w_out, b_out) -> tuple[torch.Tensor, float]:
    """In bfloat16 (float16) the kernel and the plain version each round u to
    x's type after float32 sums taken in other orders, so a u next to a
    rounding tie may round one unit apart (2^-8 or 2^-11 relative), and
    moves y[m, n] by that unit times
    |W_out[n, f]|. Per output, the sum of that over the u of its row that lie
    within TIE of a tie; and the share of such u."""
    h, g = F.linear(x.float(), w_in.float(), b_in.float()).chunk(2, dim=-1)
    u = h * F.gelu(g, approximate="tanh")
    spread = (u * (1 + TIE)).to(x.dtype).float() - (u * (1 - TIE)).to(x.dtype).float()
    return spread.abs() @ w_out.float().abs().T, (spread != 0).float().mean().item()


def geglu_library(x, w_in, b_in, w_out, b_out):
    h, g = F.linear(x, w_in, b_in).chunk(2, dim=-1)
    return F.linear(h * F.gelu(g, approximate="tanh"), w_out, b_out)


KERNELS = {
    "latent_attention": {
        "wrapper": latent_attention,
        "plain": reference_attention,
        "library": attention_library,
        "inputs": attention_inputs,
        "work": attention_work,
        "row_dim": 2,  # q's L: rows the kernel computes independently
        "label": "B={} H={} L={} N={} dh={}",
        "source": "news_recommendation_project_v2_torch/ops/csrc/latent_attention.cu",
        "replaces": "news_recommendation_project_v2_tpu/ops/pallas_attention.py:26",
    },
    "geglu": {
        "wrapper": geglu,
        "plain": reference_geglu,
        "library": geglu_library,
        "inputs": geglu_inputs,
        "work": geglu_work,
        "row_dim": 0,  # x's C
        "label": "C={} D={} F={}",
        "source": "news_recommendation_project_v2_torch/ops/csrc/geglu.cu",
        "replaces": "news_recommendation_project_v2_tpu/ops/pallas_geglu.py:29",
    },
}

def kernel_launches() -> dict:
    return {k: v["wrapper"].launches for k, v in KERNELS.items()}


def zero_launches() -> None:
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
        spec["wrapper"].shapes.clear()


def typed_shapes(dtype) -> dict:
    """The kernels' launches by (shape, type) since the counts were last
    set to 0."""
    return {k: collections.Counter({(s, dtype): n for s, n in v["wrapper"].shapes.items()}) for k, v in KERNELS.items()}


def add_shapes(total: dict, more: dict) -> dict:
    return {k: total.get(k, collections.Counter()) + more.get(k, collections.Counter()) for k in KERNELS}


# The plain versions run on pieces of at most this many rows. At the flat
# eval's chunks one call would not fit on the card beside the graph-capture
# copy (the float32 [C, 8F] GEGLU intermediate at C = 524,288 is 17 GB); the
# rows are independent, so the pieces compute the same function.
PIECE_ROWS = 1 << 17


def measure(name: str, shape: tuple, dtype, gen) -> dict:
    """One kernel against its plain version on the same inputs: the largest
    absolute difference; the times of the kernel's wrapper, of the plain
    version (over all its row pieces) and of the library call, each as calls
    back to back (host costs included: ``ms``, ``plain_ms``, ``library_ms``)
    and as device times (calls captured in a CUDA graph and replayed:
    ``device_ms``, ``plain_device_ms``, ``library_device_ms``); and the
    bound from the work's operations and bytes."""
    spec = KERNELS[name]
    args = spec["inputs"](shape, dtype, gen)
    dim = spec["row_dim"]
    n = args[0].shape[dim]
    starts = range(0, n, PIECE_ROWS)
    pieces = [(args[0].narrow(dim, a, min(PIECE_ROWS, n - a)), *args[1:]) for a in starts]
    got = spec["wrapper"](*args)
    torch.cuda.synchronize()
    err = excess = near_tie = 0.0
    err64 = [0.0, 0.0]
    for a, piece in zip(starts, pieces):
        g = got.narrow(dim, a, piece[0].shape[dim]).float()
        want = spec["plain"](*piece).float()
        diff = (g - want).abs()
        err = max(err, diff.max().item())
        if name == "geglu" and dtype != torch.float32:
            allowance, share = geglu_tie_allowance(*piece)
            diff = diff - allowance
            near_tie += share * piece[0].shape[dim] / n
        excess = max(excess, diff.max().item())
        if name == "latent_attention":
            # Both against float64, to show the kernel and the plain version
            # are independent computations even where they agree to the bit.
            q, k, v = (t.double() for t in piece)
            p64 = torch.softmax(torch.einsum("bhld,hnd->bhln", q, k) * q.shape[-1] ** -0.5, -1)
            o64 = torch.einsum("bhln,hnd->bhld", p64, v)
            err64 = [max(err64[0], (g.double() - o64).abs().max().item()),
                     max(err64[1], (want.double() - o64).abs().max().item())]
            del q, p64, o64
        del g, want, diff

    def plain():
        for piece in pieces:
            spec["plain"](*piece)

    ops, nbytes = spec["work"](shape, args[0].element_size())
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    iters, reps, rounds = (20, 10, 5) if ops < 1e10 else (5, 1, 5) if ops < 1e12 else (3, 1, 2)
    r = dict(
        label=spec["label"].format(*shape),
        err=err,
        ms=cuda_ms(lambda: spec["wrapper"](*args), iters),
        plain_ms=cuda_ms(plain, iters),
        library_ms=cuda_ms(lambda: spec["library"](*args), iters),
        device_ms=graph_ms(lambda: spec["wrapper"](*args), reps, rounds),
        plain_device_ms=graph_ms(plain, reps, rounds),
        library_device_ms=graph_ms(lambda: spec["library"](*args), reps, rounds),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
    )
    if name == "latent_attention":
        r["err64"] = tuple(err64)
    tol = TOL[(name, dtype)]
    if len(pieces) > 1:
        log(f"  {name} {str(dtype)[6:]} {r['label']}: the plain version runs on {len(pieces)} pieces of rows")
    if name == "geglu" and dtype != torch.float32:
        log(
            f"  {name} {str(dtype)[6:]} {r['label']}: {near_tie:.3%} of u within {TIE:.3g} of a rounding tie; "
            f"error beyond their one-unit roundings {excess:.3g} (tol {tol:.3g})"
        )
    log(
        f"  {name} {str(dtype)[6:]} {r['label']}: max_abs_err {r['err']:.3g} (tol {tol:.3g}) "
        f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
        f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}), share of bound {r['bound_ms'] / r['ms']:.1%}; "
        f"device: kernel {r['device_ms']:.4f} plain {r['plain_device_ms']:.4f} "
        f"library {r['library_device_ms']:.4f}, share of bound {r['bound_ms'] / r['device_ms']:.1%}"
    )
    if "err64" in r:
        log(f"    vs float64: kernel {r['err64'][0]:.3g}, plain {r['err64'][1]:.3g}")
    if not excess <= tol:
        raise AssertionError(f"{name} {dtype} {r['label']}: error {excess} > {tol}")
    return r


# The float32 GEGLU where the main path calls it: one request's 37 tokens,
# the flat eval's token chunk, the flat train step's tokens, and the
# NV-Embed tower (D = 4,096) over 8,192 tokens.
GEGLU_MAIN_SHAPES = ((37, DIM, 4 * DIM), (262144, DIM, 4 * DIM), (65536, DIM, 4 * DIM), (8192, 4096, 16384))


def geglu_route_phase(gen) -> list[dict]:
    """The float32 GEGLU at ``GEGLU_MAIN_SHAPES``, each on the route
    ``plan_geglu`` picks (warpgroup MMA or mma.sync), against its bound,
    its plain version and the library call."""
    records = []
    with torch.no_grad():
        for shape in GEGLU_MAIN_SHAPES:
            before = collections.Counter(geglu.routes)
            r = measure("geglu", shape, torch.float32, gen)
            r["route"] = next(k[0] for k, n in geglu.routes.items() if n > before[k])
            log(f"  geglu float32 {r['label']}: route {r['route']}")
            records.append(r)
    return records


def kernel_phase(gen) -> None:
    """Every kernel vs its plain version at the serving shapes that bound the
    path's range (a single request's 16 history rows, eight short and eight
    600-long history rows, and two and four rows of the 256 and 600 history
    buckets between them; one request's 37 tokens and eight 600-token rows),
    in float32 and bfloat16, the GEGLU at D=1536, wider than a 1024 row, and
    the attention at the flat eval's [1, 8, 131072, 512] in float32; then the
    float32 GEGLU at the main path's shapes (``geglu_route_phase``)."""
    cases = [
        ("latent_attention", (b, 8, l, 64, 512))
        for b, l in ((1, 16), (8, 16), (2, 256), (4, 256), (2, 600), (4, 600), (8, 600))
    ]
    cases += [("geglu", (c, DIM, 4 * DIM)) for c in (37, 4800)]
    cases += [("geglu", (37, 1536, 4 * 1536))]
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for name, shape in cases:
                measure(name, shape, dtype, gen)
        measure("latent_attention", (1, 8, 131072, 64, 512), torch.float32, gen)
    geglu_route_phase(gen)


TIMES = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms", "library_device_ms")


# (kernel, shape, type) -> measure()'s record, so that a shape two paths
# launch (the padded eval's and the padded train steps' largest) is measured
# once in a run.
MEASURED: dict = {}


def measured(name: str, shape: tuple, dtype, gen) -> dict:
    """``measure``'s record of (kernel, shape, type), taken once a run."""
    if (name, shape, dtype) not in MEASURED:
        MEASURED[(name, shape, dtype)] = measure(name, shape, dtype, gen)
    return MEASURED[(name, shape, dtype)]


def main_path_phase(shapes: dict, gen, path: str = "main path") -> dict[str, dict]:
    """Every kernel vs its plain version at each (shape, type) ``path``
    launched it at. Per kernel, the times and the bound are summed over the
    path's launches: each shape's figure times the number of launches at
    that shape."""
    record = {}
    with torch.no_grad():
        for name, counts in shapes.items():
            keys = sorted(counts, key=lambda k: (str(k[1]), k[0]))
            rows = [(counts[k], measured(name, k[0], k[1], gen)) for k in keys]
            by = {"operations": 0.0, "bytes": 0.0}
            for n, r in rows:
                by[r["bound_by"]] += n * r["bound_ms"]
            types = "+".join(sorted({str(k[1])[6:] for k in keys}))
            record[name] = dict(
                label=f"{path}: {len(rows)} shapes, {sum(n for n, _ in rows)} launches, {types}",
                err=max(r["err"] for _, r in rows),
                **{k: sum(n * r[k] for n, r in rows) for k in (*TIMES, "bound_ms")},
                bound_by=max(by, key=by.get),
            )
            r = record[name]
            log(f"  {name} launches by shape on the {path}: " + ", ".join(
                f"{MEASURED[(name, *k)]['label']} x{counts[k]}" for k in keys
            ))
            log(
                f"  {name} summed over the {path}'s launches: kernel_ms {r['ms']:.4f} "
                f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
                f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}), share of bound {r['bound_ms'] / r['ms']:.1%}; "
                f"device: kernel {r['device_ms']:.4f} plain {r['plain_device_ms']:.4f} "
                f"library {r['library_device_ms']:.4f}, share of bound {r['bound_ms'] / r['device_ms']:.1%}"
            )
    return record


def build_workload(rng: np.random.Generator, num_rows: int = FLAT_ROWS, num_news: int = NUM_NEWS):
    """bench.py's MIND-small-scale eval workload, draw for draw (a CPU test
    holds the two equal): geometric histories (mean 33, capped at 600),
    Poisson(37) candidates clipped to 2-300, click labels with at least one
    positive and one negative per impression. Returns (hist_lens, imp_lens,
    hist_rev, cand_rev, cand_row, labels)."""
    hist_lens = np.minimum(rng.geometric(1.0 / 33, size=num_rows), 600).astype(np.int32)
    imp_lens = np.clip(rng.poisson(37, size=num_rows), 2, 300).astype(np.int32)
    hist_rev = rng.integers(0, num_news, size=int(hist_lens.sum())).astype(np.int32)
    cand_rev = rng.integers(0, num_news, size=int(imp_lens.sum())).astype(np.int32)
    cand_row = np.repeat(np.arange(num_rows, dtype=np.int32), imp_lens)
    labels = (rng.random(len(cand_rev)) < 0.2).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(imp_lens)])
    labels[offsets[:-1]] = 1.0
    labels[offsets[1:] - 1] = 0.0
    return hist_lens, imp_lens, hist_rev, cand_rev, cand_row, labels


def mind_like_requests(rng: np.random.Generator, ids: list[str], n: int) -> list:
    """Geometric histories (mean 29, capped at 600), 10-90 candidates."""
    out = []
    for _ in range(n):
        h = int(np.clip(rng.geometric(1 / 29.0), 1, 600))
        c = int(rng.integers(10, 90))
        out.append(
            (
                [ids[j] for j in rng.integers(0, len(ids), h)],
                [ids[j] for j in rng.integers(0, len(ids), c)],
            )
        )
    return out


def check_ranked(ranked, candidates) -> None:
    if sorted(c for c, _ in ranked) != sorted(candidates):
        raise AssertionError("the ranked ids are not the request's candidates")
    scores = np.array([s for _, s in ranked])
    if not (np.isfinite(scores).all() and (np.diff(scores) <= 0).all()):
        raise AssertionError(f"scores not finite and descending: {scores}")


def profile_call(label: str, fn, top: int = 10) -> dict:
    """Device time by kernel for one call of ``fn``, and the device's busy
    share of the wall time (both under the profiler, which slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        (
            (e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    log(
        f"  profile of one {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({busy / wall_ms:.1%}); device time by kernel:"
    )
    for ms, count, key in rows[:top]:
        log(f"    {ms:9.3f} ms {count:5d}x  {key[:100]}")
    return dict(wall_ms=wall_ms, busy_ms=busy)


def serve_phase(device: str, work_dir: Path, num_news: int, tower_config: TowerConfig) -> dict:
    """Drive the port's serving path as a user would. Returns the launch
    counts (in all and per path) and the launches by shape, requests/s and
    the CPU comparison's largest score difference."""
    rng = np.random.default_rng(SEED)
    ckpt = work_dir / "tower.pt"
    torch.save(latent_state_dict_from_jax(random_latent_params(rng, tower_config)), ckpt)
    dim = tower_config.reduced_dim
    emb = rng.standard_normal((num_news, dim), dtype=np.float32) * 0.05
    ids = [f"N{i}" for i in range(num_news)]
    save_embeddings(work_dir / "emb", "MINDsmall_dev", emb, news_ids=np.array(ids))
    del emb
    t0 = time.perf_counter()
    ranker = build_ranker(work_dir / "emb", "MINDsmall_dev", ckpt, tower_config, device=device)
    log(f"  build_ranker: {time.perf_counter() - t0:.2f}s ({num_news} x {dim} table)")
    requests = mind_like_requests(rng, ids, N_REQUESTS)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    server = make_server(ranker, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:

        def http_rank():
            hist, cands = requests[1]
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/rank",
                data=json.dumps({"history": hist, "candidates": cands}).encode(),
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=300) as resp:
                ranked = json.loads(resp.read())["ranked"]
            check_ranked([(c, s) for c, s in ranked], cands)
            return ranked

        paths = {
            "rank": lambda: check_ranked(ranker.rank(*requests[0]), requests[0][1]),
            "retrieve": lambda: ranker.retrieve(requests[0][0], k=10),
            "rank_batch": lambda: ranker.rank_batch(requests),
            "http_rank": http_rank,
        }
        launches, results = {}, {}
        zero_launches()
        for path, run in paths.items():
            before = kernel_launches()
            results[path] = run()
            sync()
            launches[path] = {k: n - before[k] for k, n in kernel_launches().items()}
        total = kernel_launches()
        shapes = {k: collections.Counter(v["wrapper"].shapes) for k, v in KERNELS.items()}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"  launches per path: {json.dumps(launches)}")

    top = results["retrieve"]
    if not (len(top) == 10 and (np.diff([s for _, s in top]) <= 0).all()):
        raise AssertionError(f"retrieve(k=10) gave {top}")
    for (_, cands), ranked in zip(requests, results["rank_batch"]):
        check_ranked(ranked, cands)
    for name, n in total.items():
        if device == "cuda" and n == 0:
            raise AssertionError(f"the serving path never launched the {name} kernel")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ranker.rank_batch(requests)
        sync()
        times.append(time.perf_counter() - t0)
    rps = [N_REQUESTS / t for t in times]
    if device == "cuda":
        profile_call("rank_batch", lambda: ranker.rank_batch(requests))

    cpu = build_ranker(work_dir / "emb", "MINDsmall_dev", ckpt, tower_config, device="cpu")
    diff = 0.0
    for (_, cands), got, want in zip(requests[:4], results["rank_batch"], cpu.rank_batch(requests[:4])):
        a, b = dict(got), dict(want)
        diff = max(diff, max(abs(a[c] - b[c]) for c in cands))
    return dict(launches=total, shapes=shapes, rps=rps, cpu_diff=diff, requests=requests)


def boundary_rows(hist_lens: np.ndarray, chunk: int, n: int = 64) -> np.ndarray:
    """About ``n`` rows, ascending, centred on the flat eval's token-chunk
    boundaries: the rows whose tokens straddle two chunks, where the pool
    carries a row's sum from one chunk into the next, and their neighbours."""
    ends = np.cumsum(hist_lens)
    cuts = np.arange(chunk, int(ends[-1]), chunk)
    if not len(cuts):
        return np.arange(min(n, len(hist_lens)))
    half = max(1, n // (2 * len(cuts)))
    mid = np.searchsorted(ends, cuts, side="right")  # the row holding token ``cut``
    return np.unique(np.clip(mid[:, None] + np.arange(-half, half), 0, len(hist_lens) - 1))


def take_rows(rows, hist_rev, hist_lens, cand_rev, imp_lens) -> tuple[tuple, np.ndarray]:
    """The flat arrays of ``rows`` alone (candidate rows numbered 0 up), and
    the positions of their candidate slots in the whole workload's."""
    h_off, c_off = lengths_to_offsets(hist_lens), lengths_to_offsets(imp_lens)
    hist = np.concatenate([np.arange(h_off[r], h_off[r + 1]) for r in rows])
    slots = np.concatenate([np.arange(c_off[r], c_off[r + 1]) for r in rows])
    cand_row = np.repeat(np.arange(len(rows)), imp_lens[rows])
    return (hist_rev[hist], hist_lens[rows], cand_rev[slots], cand_row), slots


def padded_scores(tower, emb, hist_rev, hist_lens, cand_rev, cand_row) -> np.ndarray:
    """Cosine scores through the tower's padded, masked call, as the serving
    path makes it: histories gathered into [rows, max_len, D] with zero pad
    rows and a mask, the tower's own pool, the cosine with 1e-8 clamps."""
    n, width = len(hist_lens), int(hist_lens.max())
    ends = np.cumsum(hist_lens)
    idx = np.zeros((n, width), np.int64)
    mask = np.zeros((n, width), np.float32)
    for r in range(n):
        idx[r, : hist_lens[r]] = hist_rev[ends[r] - hist_lens[r] : ends[r]]
        mask[r, : hist_lens[r]] = 1.0
    idx_t, mask_t = torch.from_numpy(idx).cuda(), torch.from_numpy(mask).cuda()
    with torch.inference_mode():
        user = tower(emb[idx_t] * mask_t[..., None], mask_t).float()
        u = user[torch.from_numpy(cand_row.astype(np.int64)).cuda()]
        c = emb[torch.from_numpy(cand_rev.astype(np.int64)).cuda()]
        nu = torch.linalg.vector_norm(u, dim=-1).clamp_min(1e-8)
        nc = torch.linalg.vector_norm(c, dim=-1).clamp_min(1e-8)
        return ((u * c).sum(-1) / (nu * nc)).cpu().numpy()


def flat_eval_run(dtype, state: dict, emb: torch.Tensor, mplan, work: tuple) -> dict:
    """One type's flat eval over the whole workload, as bench.py runs it:
    the main-path run (launch counts set to 0 just before and read just
    after, the peak memory, which warms every shape), three timed ``score``
    and ``metrics`` runs, a profiled ``metrics`` run, a count of its host syncs,
    and the checks of this type."""
    hist_lens, imp_lens, hist_rev, cand_rev, cand_row, _ = work
    kind = str(dtype)[6:]
    cfg = TowerConfig(kind="latent", compute_dtype=kind)
    tower = build_tower(cfg)
    tower.load_state_dict(state)
    tower = tower.to("cuda", dtype)  # bfloat16: every parameter, as bench.py casts them
    query = emb.to(dtype)
    chunk = estimate_flat_chunk(cfg, device="cuda")
    t0 = time.perf_counter()
    plan = FlatEvalPlan(hist_rev, hist_lens, cand_rev, cand_row, chunk_tokens=chunk)
    n_chunks = len(plan.history.chunks)
    log(
        f"  {kind}: estimate_flat_chunk picked {chunk:,} tokens ({n_chunks} chunks, "
        f"{n_chunks * chunk:,} token rows with the last chunk's pad); FlatEvalPlan built in "
        f"{time.perf_counter() - t0:.2f}s"
    )

    def metrics():
        return plan.metrics(tower, emb, mplan, query_news_emb=query)

    def score():
        return plan.score(tower, emb, query_news_emb=query)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches()
    t0 = time.perf_counter()
    first = metrics()
    first_s = time.perf_counter() - t0
    launches = kernel_launches()
    shapes = {k: collections.Counter({(s, dtype): n for s, n in v["wrapper"].shapes.items()})
              for k, v in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() - base
    total = torch.cuda.get_device_properties(0).total_memory
    model = chunk * flat_token_bytes(cfg)
    log(
        f"  {kind}: main-path metrics run {first_s:.2f}s (first call), {first}; launches "
        f"{json.dumps(launches)}, shapes {dict((k, {str(s[0]): n for s, n in c.items()}) for k, c in shapes.items())}"
    )
    log(
        f"  {kind}: peak memory above the tables and plans {peak / 1e9:.3f} GB = {peak / chunk:,.0f} bytes "
        f"a chunk token; the memory model's share {model / 1e9:.3f} GB ({flat_token_bytes(cfg):,} bytes a "
        f"token), its budget a quarter of {total / 1e9:.3f} GB"
    )
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"check 1: the {kind} flat eval never launched the {name} kernel")

    score_s, scores = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        scores.append(score())
        score_s.append(time.perf_counter() - t0)
    metrics_s, results = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        results.append(metrics())
        metrics_s.append(time.perf_counter() - t0)
    ips = [FLAT_ROWS / s for s in score_s], [FLAT_ROWS / s for s in metrics_s]
    log(
        f"  {kind}: score runs {['%.3f' % s for s in score_s]} s, impressions/s {['%.0f' % r for r in ips[0]]}; "
        f"metrics runs {['%.3f' % s for s in metrics_s]} s, impressions/s {['%.0f' % r for r in ips[1]]}"
    )
    prof = profile_call(f"{kind} FlatEvalPlan.metrics", metrics, top=14)
    syncs = count_syncs(metrics)
    log(f"  {kind}: host syncs in one metrics call: {syncs} (want 1)")
    if syncs != 1:
        raise AssertionError(f"the {kind} metrics call synced {syncs} times")

    if not (scores[0].shape == (len(cand_rev),) and np.isfinite(scores[0]).all()):
        raise AssertionError(f"{kind} scores: shape {scores[0].shape}, finite {np.isfinite(scores[0]).all()}")
    same = all(s.tobytes() == scores[0].tobytes() for s in scores[1:])
    log(f"  check 3 ({kind}): three score runs bit-identical: {same}")
    if not same:
        raise AssertionError(f"check 3: two {kind} score runs differ")
    direct = mplan.compute(scores[0])
    gap = max(abs(direct[k] - results[0][k]) for k in ("auc", "mrr", "ndcg5", "ndcg10"))
    log(f"  check 4 ({kind}): metrics vs DeviceMetricsPlan.compute(score): max difference {gap:.3g} (tol 1e-6)")
    if not (gap <= 1e-6 and direct["num_samples"] == results[0]["num_samples"] == FLAT_ROWS):
        raise AssertionError(f"check 4: {direct} vs {results[0]}")

    if dtype == torch.float32:
        rows = boundary_rows(hist_lens, chunk)
        sub, slots = take_rows(rows, hist_rev, hist_lens, cand_rev, imp_lens)
        ends = np.cumsum(hist_lens)
        cuts = np.arange(chunk, int(ends[-1]), chunk)
        straddle = sum(bool(((ends[r] - hist_lens[r] < cuts) & (cuts < ends[r])).any()) for r in rows)
        which = f"{len(rows)} rows about the {len(cuts)} chunk boundaries ({straddle} straddle one)"
        card = scores[0][slots]
        cpu_tower = build_tower(cfg)
        cpu_tower.load_state_dict(state)
        cpu = FlatEvalPlan(*sub, chunk_tokens=1024, cand_chunk=1024, device="cpu").score(cpu_tower, emb.cpu())
        diff = np.abs(cpu - card).max()
        log(f"  check 2: {which}: scores vs the same FlatEvalPlan on the CPU: max difference {diff:.3g} (tol 1e-4)")
        if not (straddle and diff <= 1e-4):
            raise AssertionError(f"check 2: card and CPU differ by {diff}; {straddle} rows straddle a chunk")
        diff = np.abs(padded_scores(tower, emb, *sub) - card).max()
        log(f"  check 5: {which}: flat scores vs the padded, masked tower call: max difference {diff:.3g} (tol 1e-5)")
        if not diff <= 1e-5:
            raise AssertionError(f"check 5: flat and padded paths differ by {diff}")
    return dict(
        scores=scores[0], launches=launches, shapes=shapes, chunk=chunk, peak=peak,
        score_ips=ips[0], metrics_ips=ips[1], busy=prof, metrics=results[0],
    )


def flat_eval_phase(gen) -> tuple[dict, torch.Tensor]:
    """The port's flat eval at full width over bench.py's MIND-small-scale
    workload, in float32 and in bfloat16. Returns the runs and the table
    (12d runs the sharded eval on it)."""
    work = build_workload(np.random.default_rng(SEED))
    hist_lens, imp_lens, _, cand_rev, _, labels = work
    log(
        f"  workload: {FLAT_ROWS:,} rows, {int(hist_lens.sum()):,} history tokens, "
        f"{len(cand_rev):,} candidate slots, {NUM_NEWS:,} news (bench.py's build_workload, seed {SEED})"
    )
    cfg = TowerConfig(kind="latent")
    state = latent_state_dict_from_jax(random_latent_params(np.random.default_rng(SEED), cfg))
    # A row-normalized table made on the card, as bench.py makes it.
    emb = torch.randn((NUM_NEWS, cfg.reduced_dim), device="cuda", generator=gen)
    emb = emb / torch.linalg.norm(emb, dim=1, keepdim=True)
    t0 = time.perf_counter()
    mplan = DeviceMetricsPlan(imp_lens, labels, hist_slots=np.arange(len(cand_rev), dtype=np.int64))
    log(f"  DeviceMetricsPlan built in {time.perf_counter() - t0:.2f}s ({len(mplan.grids)} length buckets)")
    runs = {dtype: flat_eval_run(dtype, state, emb, mplan, work) for dtype in (torch.float32, torch.bfloat16)}
    f32, bf16 = runs[torch.float32]["scores"], runs[torch.bfloat16]["scores"]
    rel = float(np.linalg.norm(bf16 - f32) / np.linalg.norm(f32))
    log(f"  check 6: bfloat16 scores vs float32, norm-relative difference {rel:.3g} (tol 3e-2)")
    if not rel <= 3e-2:
        raise AssertionError(f"check 6: bfloat16 and float32 scores differ by {rel}")
    return runs, emb


# ---------------------------------------------------------------------------
# Phase 7: training on the card
# ---------------------------------------------------------------------------

# Timed steps of 7b, 8c.2 and 9c (and 14b-14d), reduced for the smoke's
# time (PERF.md §4 lists the cuts).
TRAIN_B, TRAIN_K, TRAIN_STEPS = 2048, 5, 5
# 7c's epoch at MIND-small's scale runs on half of bench.py's rows (its
# train rows drawn as build_workload draws them), to keep the smoke's time.
MIND_TRAIN_ROWS, MIND_VAL_ROWS = FLAT_ROWS // 2, 5_000
CHECK_B = 64
# Card against CPU on one step: both compute float32-accurate products (the
# kernels as 3xTF32) summed in other orders.
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
# The bench_trained_metrics fixture on the card against the CPU: the CPU
# test's tolerances (tests/test_torch_trainer.py).
EPOCH_LOSS_REL, EPOCH_METRIC_ABS = 1e-5, 2e-3
METRIC_KEYS = ("auc", "mrr", "ndcg5", "ndcg10")
LOSSES = {
    "margin": (flat_margin_loss, flat_margin_step, {"margin": TrainConfig().margin}),
    "infonce": (flat_infonce_loss, flat_infonce_step, {}),
}


def flat_inputs(B: int, rng: np.random.Generator, num_news: int = NUM_NEWS):
    """benchmarks/train_profile.py's worst-case flat batch (no dedup, U = B;
    histories geometric with mean 29, capped at 600; tokens padded to a
    power of two of at least 1,024), draw for draw, as numpy arrays (a CPU
    test holds the two equal). Returns (T, live tokens, batch)."""
    lens = np.clip(rng.geometric(1 / 29.0, size=B), 1, 600).astype(np.int64)
    total = int(lens.sum())
    T = max(1024, 1 << int(np.ceil(np.log2(total))))
    tok_idx = np.zeros(T, np.int32)
    tok_idx[:total] = rng.integers(0, num_news, total)
    tok_rows = np.full(T, B, np.int32)
    tok_rows[:total] = np.repeat(np.arange(B, dtype=np.int32), lens)
    return T, total, (
        tok_idx,
        tok_rows,
        lens.astype(np.float32),
        rng.integers(0, B, B).astype(np.int32),
        rng.integers(0, num_news, B).astype(np.int32),
        rng.integers(0, num_news, B).astype(np.int32),
        np.ones(B, np.float32),
    )


def with_negatives(batch: tuple, rng: np.random.Generator, k: int = TRAIN_K) -> tuple:
    """The batch with K negatives a pair, the InfoNCE step's input."""
    return batch[:5] + (rng.integers(0, NUM_NEWS, (len(batch[3]), k)).astype(np.int32),) + batch[6:]


def on(batch: tuple, device) -> tuple:
    return tuple(torch.from_numpy(a).to(device) for a in batch)


def full_tower(state: dict, device, compute: str = "float32"):
    tower = build_tower(TowerConfig(kind="latent", compute_dtype=compute))
    tower.load_state_dict(state)
    return tower.to(device)


def norm_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def train_check_phase(state: dict, emb: torch.Tensor) -> None:
    """7a: full width, float32, one flat batch at B=64 (T = 2,048): the
    margin and InfoNCE losses and every parameter's gradient on the card
    against the CPU from the same weights; both kernels launched forward;
    two runs of 5 steps from one state give the same parameter bits."""
    rng = np.random.default_rng(SEED + 7)
    T, total, batch = flat_inputs(CHECK_B, rng)
    batches = {"margin": batch, "infonce": with_negatives(batch, rng)}
    emb_cpu = emb.cpu()
    for name, b in batches.items():
        loss_fn, _, kw = LOSSES[name]
        losses, grads = {}, {}
        for dev, table in (("cuda", emb), ("cpu", emb_cpu)):
            tower = full_tower(state, dev)
            before = kernel_launches()
            loss = loss_fn(tower, table, on(b, dev), **kw)
            loss.backward()
            if dev == "cuda":
                torch.cuda.synchronize()
                launched = {k: n - before[k] for k, n in kernel_launches().items()}
            losses[dev] = loss.item()
            grads[dev] = {n: p.grad.detach().cpu() for n, p in tower.named_parameters()}
            del tower, loss
        worst = max((norm_rel(grads["cuda"][n], g), n) for n, g in grads["cpu"].items())
        gap = abs(losses["cuda"] - losses["cpu"])
        log(
            f"  7a {name}: B={CHECK_B}, T={T:,} ({total:,} live tokens): loss card {losses['cuda']:.7f} "
            f"CPU {losses['cpu']:.7f}, difference {gap:.3g} (tol {LOSS_TOL:g}); largest gradient "
            f"difference {worst[0]:.3g} norm-relative ({worst[1]}; tol {GRAD_TOL:g}); forward launches {launched}"
        )
        if not (gap <= LOSS_TOL and worst[0] <= GRAD_TOL and min(launched.values()) >= 1):
            raise AssertionError(f"7a {name}: card and CPU differ (loss {gap}, gradient {worst}) or {launched}")
    cuda_batches = {name: on(b, "cuda") for name, b in batches.items()}
    finals = []
    for _ in range(2):
        tower = full_tower(state, "cuda")
        opt = make_optimizer(TrainConfig(), tower.parameters())
        for i in range(5):
            name = ("margin", "infonce")[i % 2]
            _, step_fn, kw = LOSSES[name]
            step_fn(tower, opt, emb, cuda_batches[name], **kw)
        torch.cuda.synchronize()
        finals.append([p.detach().clone() for p in tower.parameters()])
    same = all(torch.equal(a, b) for a, b in zip(*finals))
    log(f"  7a: two runs of 5 steps (margin and InfoNCE in turn) from one state give the same parameter bits: {same}")
    if not same:
        raise AssertionError("7a: two runs of 5 steps from one state differ")


CUBLAS_NAMES = ("gemm", "gemv", "xmma", "cutlass", "nvjet")


def part(times: dict, test) -> float:
    """The device time (ms) of the kernels whose names pass ``test``."""
    return sum(ms for key, ms in times.items() if test(key))


def ours(key: str) -> bool:
    """A kernel of ours (csrc/)."""
    return any(k in key for k in ("geglu_", "latent_attention_kernel"))


def cublas(key: str) -> bool:
    """A cuBLAS (or CUTLASS) GEMM."""
    return any(k in key.lower() for k in CUBLAS_NAMES) and not ours(key)


# The profiler has been seen to drop a window's kernels late in a long run
# (a step's forward at 0.04 ms of its 14). A split whose part the profiler
# covers less than PROFILE_COVER of, against the part's span on CUDA events,
# is taken again, up to PROFILE_TRIES times.
PROFILE_TRIES, PROFILE_COVER = 3, 0.2


def device_ms_by_kernel(fn) -> tuple[object, dict, float]:
    """``fn()``'s result, its device time by kernel name (ms) under the
    profiler, synchronized at the end, and that time's share of ``fn``'s
    span on CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    times = {
        e.key: e.self_device_time_total / 1e3
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    }
    return out, times, sum(times.values()) / max(start.elapsed_time(end), 1e-6)


def event_ms(fn) -> float:
    """``fn()``'s span (ms) on CUDA events, synchronized before and after:
    a split's optimizer part, whose short kernels the profiler has dropped
    late in a long run (it read 0 there)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def profiled_parts(run) -> tuple[list, int]:
    """``run()``'s list of (result, times, cover) per part, taken again while
    a part's cover is below PROFILE_COVER, up to PROFILE_TRIES times; and
    the tries it took."""
    for tries in range(1, PROFILE_TRIES + 1):
        parts = run()
        if min(cover for _, _, cover in parts) >= PROFILE_COVER:
            break
    return parts, tries


def step_split(opt, loss_call, label: str) -> dict:
    """One step's device time by part, each part under the profiler with a
    synchronize after it: the forward (``loss_call()``)'s hand-written
    kernels, its cuBLAS GEMMs and the rest of it; the plain backward's GEMMs
    (cuBLAS: the linears, the GEGLU recompute, the attention's einsums) and
    the rest of it (GELU, softmax, reductions, copies); the optimizer (clip
    and AdamW) on CUDA events. Taken again where the profiler dropped a
    part's kernels."""
    optimizer_ms = []

    def run():
        loss, fwd, c1 = device_ms_by_kernel(loss_call)
        parts = [(loss, fwd, c1), device_ms_by_kernel(loss.backward)]
        optimizer_ms.append(event_ms(lambda: (opt.step(), opt.zero_grad(set_to_none=True))))
        return parts

    parts, tries = profiled_parts(run)
    (_, fwd, _), (_, bwd, _) = parts
    split = {
        "forward kernels": part(fwd, ours),
        "forward cuBLAS": part(fwd, cublas),
        "forward rest": part(fwd, lambda k: not ours(k) and not cublas(k)),
        "backward GEMMs": part(bwd, cublas),
        "backward rest": part(bwd, lambda k: not cublas(k)),
        "optimizer": optimizer_ms[-1],
    }
    split["total"] = sum(split.values())
    if not split["optimizer"] > 0:
        raise AssertionError(f"{label}: the optimizer's part read {split['optimizer']} ms")
    top = sorted(bwd.items(), key=lambda kv: -kv[1])[:6]
    log(
        f"  {label}: one step's device time by part (ms): "
        + ", ".join(f"{k} {v:.2f} ({v / split['total']:.1%})" for k, v in split.items() if k != "total")
        + f"; total {split['total']:.2f}; profiler's cover of the profiled parts' spans "
        + ", ".join(f"{c:.0%}" for _, _, c in parts) + f" ({tries} tries; the optimizer on CUDA events)"
    )
    for key, ms in top:
        log(f"    backward {ms:9.3f} ms  {key[:100]}")
    return split


def timed_steps(step, inputs: list, warm: int, dtype) -> dict:
    """``step(x)`` (which returns the step's loss) for each of ``inputs``:
    the first ``warm`` as warm-up, the rest timed with the loss fetched
    every step, the peak memory reset and the launch counts set to 0 just
    before them and read just after. Returns the losses (warm-up first), ms
    a timed step, the peak memory above the start (GB), the launches and
    the launches by (shape, ``dtype``)."""
    losses = [step(x) for x in inputs[:warm]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches()
    t0 = time.perf_counter()
    losses += [step(x) for x in inputs[warm:]]
    ms = (time.perf_counter() - t0) * 1e3 / (len(inputs) - warm)
    return dict(losses=losses, ms=ms, peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                launches=kernel_launches(), shapes=typed_shapes(dtype))


def train_step_phase(state: dict, emb: torch.Tensor, card: str, compute: str = "float32", part: str = "7b") -> dict:
    """7b (14b in bfloat16): full width, the tower in ``compute``,
    bench.py's worst-case batch (B=2048, T = 65,536), margin and InfoNCE
    (K=5): 3 warm-up steps, then 5 timed steps with the loss fetched every
    step (as bench.py's bench_train_flat does), the peak memory, the device
    time by part, a profiled step, host syncs a step. Launch counts are set
    to 0 just before the timed steps and read just after. Returns the
    launches, the launches by shape and each loss's figures."""
    rng = np.random.default_rng(SEED)
    T, total, batch = flat_inputs(TRAIN_B, rng)
    batches = {"margin": batch, "infonce": with_negatives(batch, rng)}
    launches, shapes, figures = collections.Counter(), {}, {}
    for name, b in batches.items():
        loss_fn, step_fn, kw = LOSSES[name]
        tower = full_tower(state, "cuda", compute)
        opt = make_optimizer(TrainConfig(), tower.parameters())
        args = on(b, "cuda")

        def step(_=None):
            return float(step_fn(tower, opt, emb, args, **kw))

        r = timed_steps(step, [None] * (3 + TRAIN_STEPS), 3, getattr(torch, compute))
        launches.update(r["launches"])
        shapes = add_shapes(shapes, r["shapes"])
        log(
            f"  {part} {name}: B={TRAIN_B}, T={T:,} ({total:,} live tokens), {compute}: {r['ms']:.2f} ms/step, "
            f"{TRAIN_B * 1e3 / r['ms']:,.0f} pairs/s over {TRAIN_STEPS} steps (loss fetched every step) on {card}; "
            f"losses {r['losses'][0]:.5f} -> {r['losses'][-1]:.5f}; peak memory above the tables and weights "
            f"{r['peak_gb']:.3f} GB; launches {r['launches']}"
        )
        if not all(np.isfinite(r["losses"])):
            raise AssertionError(f"{part} {name}: a loss is not finite: {r['losses']}")
        split = step_split(opt, lambda: loss_fn(tower, emb, args, **kw), f"{part} {name}")
        figures[name] = dict(ms_per_step=r["ms"], pairs_per_s=TRAIN_B * 1e3 / r["ms"], peak_gb=r["peak_gb"],
                             device_ms_by_part=split)
        profile_call(f"{name} train step (B={TRAIN_B}, {compute})", step, top=8)
        syncs = count_syncs(step)
        log(f"  {part} {name}: host syncs in one step with its loss fetched: {syncs} (want 1)")
        if syncs != 1:
            raise AssertionError(f"{part} {name}: a step synced {syncs} times")
        del tower, opt, args
    return dict(launches=dict(launches), shapes=shapes, figures=figures, T=T, live_tokens=total)


def learnable_split(num_rows: int, n_train: int, dim: int, seed: int):
    imps, hist, emb = synthetic_learnable_behaviors(num_news=200, num_rows=num_rows, dim=dim, noise=0.05, seed=seed)
    ct = compile_behaviors(imps[:n_train], hist[:n_train]).with_history_view()
    cv = compile_behaviors(imps[n_train:], hist[n_train:]).with_history_view()
    return ct, cv, align_embeddings(ct.news_ids, emb), align_embeddings(cv.news_ids, emb)


def trainer_phase() -> list:
    """7c: TowerTrainer on the card (flat_train, flat_eval, device_metrics).
    1. bench.py's bench_trained_metrics fixture (600/200 rows, d=64, 8
       latents of 8 heads x 16, lr 3e-4, batch 128, 3 epochs), each epoch's
       loss and val metrics against the same trainer on the CPU; the best val
       AUC must pass bench.py's gate of 0.58.
    2. Full width, batch 2048, margin (full_width_epochs): the learnable
       fixture at D=1024 (20,000 train and 5,000 val rows, about 10.5
       history tokens a row, steps of T = 8,192 or less), 2 epochs; then
       bench.py's MIND-small-scale rows at half depth (build_workload's
       draws: 25,000 train rows, 33 history tokens a row, steps of T = 2,048
       or 4,096, and 5,000 val rows), 1 epoch.
    Returns the learnable fixture's epoch figures."""
    ct, cv, emb_t, emb_v = learnable_split(800, 600, 64, seed=7)
    cfg = TowerConfig(kind="latent", reduced_dim=64, num_latents=8, latent_dim_head=16)
    state = latent_state_dict_from_jax(random_latent_params(np.random.default_rng(0), cfg))
    histories = {}
    for dev in ("cuda", "cpu"):
        tower = build_tower(cfg)
        tower.load_state_dict(state)
        trainer = TowerTrainer(
            tower, ct, emb_t, compiled_val=cv, news_emb_val=emb_v,
            cfg=TrainConfig(learning_rate=3e-4, num_epochs=3, batch_size=128, seed=0),
            device_metrics=True, device=dev,
        )
        before = kernel_launches()
        t0 = time.perf_counter()
        histories[dev] = trainer.train()
        log(f"  7c fixture on {dev}: 3 epochs in {time.perf_counter() - t0:.2f}s")
        if dev == "cuda" and min(n - before[k] for k, n in kernel_launches().items()) < 1:
            raise AssertionError("7c: the trainer on the card launched no kernel")
    worst_loss = worst_metric = 0.0
    for got, want in zip(histories["cuda"], histories["cpu"]):
        worst_loss = max(worst_loss, abs(got["loss"] - want["loss"]) / abs(want["loss"]))
        worst_metric = max(worst_metric, *(abs(got["val"][k] - want["val"][k]) for k in METRIC_KEYS))
        log(
            f"  7c fixture epoch {got['epoch']}: loss card {got['loss']:.7f} CPU {want['loss']:.7f}; val "
            + ", ".join(f"{k} {got['val'][k]:.5f}/{want['val'][k]:.5f}" for k in METRIC_KEYS)
        )
    best = max(h["val"]["auc"] for h in histories["cuda"])
    log(
        f"  7c fixture: largest loss difference {worst_loss:.3g} relative (tol {EPOCH_LOSS_REL:g}), "
        f"largest val metric difference {worst_metric:.3g} (tol {EPOCH_METRIC_ABS:g}); best val AUC "
        f"{best:.4f} (bench.py's gate 0.58)"
    )
    if not (worst_loss <= EPOCH_LOSS_REL and worst_metric <= EPOCH_METRIC_ABS and best > 0.58):
        raise AssertionError(f"7c: the fixture on the card: {worst_loss}, {worst_metric}, AUC {best}")

    ct, cv, emb_t, emb_v = learnable_split(25_000, 20_000, DIM, seed=7)
    learnable, _, _ = full_width_epochs("learnable fixture", ct, cv, emb_t, emb_v, epochs=2)
    # bench.py's MIND-small-scale rows, an N(0, 1) table made on the card as
    # benchmarks/train_bench.py's main_epoch makes it.
    emb = torch.randn((NUM_NEWS, DIM), device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
    ct = mind_behaviors(np.random.default_rng(SEED), MIND_TRAIN_ROWS)
    cv = mind_behaviors(np.random.default_rng(SEED + 1), MIND_VAL_ROWS)
    full_width_epochs("MIND-small scale", ct, cv, emb, emb, epochs=1)
    return learnable



def mind_behaviors(rng: np.random.Generator, num_rows: int, num_news: int = NUM_NEWS) -> CompiledBehaviors:
    """build_workload's rows as a trainer's CompiledBehaviors over a table
    of ``num_news`` news: every row has history, and every impression holds
    both classes."""
    hist_lens, imp_lens, hist_rev, cand_rev, _, labels = build_workload(rng, num_rows, num_news)
    rows = np.arange(num_rows, dtype=np.int32)
    return CompiledBehaviors(
        news_ids=np.arange(num_news).astype(str),
        imp_rev=cand_rev,
        imp_row=np.repeat(rows, imp_lens),
        imp_lens=imp_lens,
        hist_rev=hist_rev,
        hist_row=np.repeat(rows, hist_lens),
        hist_lens=hist_lens,
        hist_row_index=rows,
        labels_flat=labels.astype(np.int8),
        label_present=True,
    )


def full_width_epochs(
    label: str, ct, cv, emb_t, emb_v, epochs: int, compute: str = "float32", part: str = "7c"
) -> tuple:
    """TowerTrainer at full width (device_metrics), margin, batch 2048: per
    epoch the wall time of its steps and pairs/s end to end (bench's
    main_epoch measure: sampling, host batch building, steps), the steps by
    T (the attention's launches in the epoch), the eval of both splits and
    the metrics. Checks: the loss is finite, the metrics lie in [0, 1], and
    every step launched the attention kernel once. The tower computes in
    ``compute``. Returns each epoch's figures, the trainer and the launches
    by (shape, type) over the epochs' steps."""
    pos = np.bincount(ct.imp_row[ct.labels_flat == 1], minlength=ct.num_rows)
    pairs = int(np.maximum(pos, ct.imp_lens - pos).sum())  # the margin sampler's pairs an epoch
    tokens = np.minimum(ct.hist_lens, HISTORY_BUCKETS[-1])
    log(
        f"  {part} {label}: {ct.num_rows:,} train rows ({int(tokens.sum()):,} history tokens, {tokens.mean():.1f} "
        f"a row; {pairs:,} pairs an epoch), {cv.num_rows:,} val rows"
    )
    state = latent_state_dict_from_jax(random_latent_params(np.random.default_rng(SEED), TowerConfig()))
    trainer = TowerTrainer(
        full_tower(state, "cuda", compute), ct, emb_t, compiled_val=cv, news_emb_val=emb_v,
        cfg=TrainConfig(batch_size=TRAIN_B, num_epochs=epochs, seed=0), device_metrics=True,
    )
    figures, shapes = [], {k: collections.Counter() for k in KERNELS}
    dtype = getattr(torch, compute)
    for epoch in range(1, epochs + 1):
        zero_launches()
        t0 = time.perf_counter()
        loss = trainer.train_one_epoch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for k, v in KERNELS.items():
            shapes[k].update({(sh, dtype): n for sh, n in v["wrapper"].shapes.items()})
        by_t = collections.Counter()
        for (_, _, length, _, _), n in latent_attention.shapes.items():
            by_t[length] += n
        train_scores, val_scores = trainer.evaluate()
        t2 = time.perf_counter()
        log(
            f"  {part} {label} epoch {epoch}: {t1 - t0:.2f}s, {pairs / (t1 - t0):,.0f} pairs/s end to end, "
            f"{sum(by_t.values())} steps by T {dict(sorted(by_t.items()))}, loss {loss:.5f}; "
            f"eval of both splits {t2 - t1:.2f}s; val {val_scores}"
        )
        values = [train_scores[k] for k in METRIC_KEYS] + [val_scores[k] for k in METRIC_KEYS]
        steps = -(-pairs // TRAIN_B)
        if not (np.isfinite(loss) and all(0.0 <= v <= 1.0 for v in values) and sum(by_t.values()) == steps):
            raise AssertionError(f"{part} {label} epoch {epoch}: loss {loss}, metrics {values}, {by_t} for {steps} steps")
        figures.append(dict(epoch=epoch, seconds=t1 - t0, pairs_per_s=pairs / (t1 - t0), loss=loss, val_auc=val_scores["auc"]))
    return figures, trainer, shapes


def train_phase(gen, card: str) -> dict:
    """Phase 7: training at full width on the card (7a, 7b, 7c)."""
    state = latent_state_dict_from_jax(random_latent_params(np.random.default_rng(SEED), TowerConfig()))
    # An unnormalized N(0, 1) table made on the card, as bench.py's
    # bench_train_flat makes it.
    emb = torch.randn((NUM_NEWS, DIM), device="cuda", generator=gen)
    train_check_phase(state, emb)
    record = train_step_phase(state, emb, card)
    del emb
    torch.cuda.empty_cache()
    record["learnable"] = trainer_phase()
    return record


# ---------------------------------------------------------------------------
# Phase 8: the padded path and the other towers on the card
# ---------------------------------------------------------------------------

PADDED_KINDS = ("latent", "final_attention", "transformer")
FWD_B, FWD_L = 64, 600
FWD_CPU_ROWS = [0, 1, 2, 3]  # a full row, the all-pad row and two MIND-like rows, on the CPU
PADDED_B = TrainConfig().batch_size
CHECK_L = 32  # 8c.1's history window: the CPU's share of the check stays small
# The learnable fixture at full width, half of 7c's 20,000 train rows: one
# epoch per tower of 40,000 margin pairs, 20 steps of 2,048.
LEARN_ROWS, LEARN_TRAIN = 12_500, 10_000


def padded_tower(kind: str, state: dict, device, compute: str = "float32", **overrides):
    tower = build_tower(TowerConfig(kind=kind, compute_dtype=compute, **overrides))
    tower.load_state_dict(state)
    return tower.to(device)


def tower_states(cfg_overrides: dict | None = None, seed: int = SEED + 8) -> dict:
    """Random weights of every user tower from one numpy seed, as
    ``state_dict``s (full width unless overridden)."""
    rng = np.random.default_rng(seed)
    out = {}
    for kind in PADDED_KINDS:
        cfg = TowerConfig(kind=kind, **(cfg_overrides or {}))
        out[kind] = tower_state_dict_from_jax(kind, random_tower_params(rng, cfg))
    return out


def part_line(part: str, **fields) -> None:
    """One JSON line of a phase 8 part's figures."""
    log(json.dumps({"part": part, **fields}))


def padded_from_flat(flat: tuple, total: int, width: int | None = None) -> tuple[int, tuple]:
    """A flat_inputs batch as TowerTrainer._epoch_batches pads one: each
    row's history end-aligned into [B, L], L the bucket of the longest (or
    ``width``), then the pair columns. Returns (L, batch)."""
    tok_idx, _, lens, hist_rev, pos, neg, mask = flat
    lens = lens.astype(np.int64)
    L = width or bucket_for(int(lens.max()), HISTORY_BUCKETS)
    idx, hmask = gather_end_aligned(tok_idx[:total], np.cumsum(lens), lens, L, out_rows=len(lens))
    return L, (idx, hmask, hist_rev, pos, neg, mask)


def padded_forward_phase(states: dict) -> None:
    """8a: every tower's forward at full width on [64, 600] MIND-like
    histories (one full row, one all pad): float32 on the card against the
    CPU on four of the rows (rows are independent), within 1e-4 of the
    output's scale; bfloat16 compute within a norm-relative 3e-2 of float32;
    every value finite, the all-pad row's too."""
    rng = np.random.default_rng(SEED + 81)
    lens = np.clip(rng.geometric(1 / 29.0, FWD_B), 1, FWD_L)
    lens[0], lens[1] = FWD_L, 0
    mask = (np.arange(FWD_L)[None] < lens[:, None]).astype(np.float32)
    emb = rng.standard_normal((FWD_B, FWD_L, DIM), dtype=np.float32) * mask[..., None]
    x, m = torch.from_numpy(emb).cuda(), torch.from_numpy(mask).cuda()
    for name, kind, extra in (
        ("final_attention", "final_attention", {}),
        ("transformer", "transformer", {}),
        ("transformer as_built", "transformer", {"as_built": True}),
        ("latent", "latent", {}),
    ):
        t0 = time.perf_counter()
        with torch.inference_mode():
            f32 = padded_tower(kind, states[kind], "cuda", **extra)(x, m).float()
            bf16 = padded_tower(kind, states[kind], "cuda", "bfloat16", **extra)(x, m).float()
            cpu = padded_tower(kind, states[kind], "cpu", **extra)(
                torch.from_numpy(emb[FWD_CPU_ROWS]), torch.from_numpy(mask[FWD_CPU_ROWS])
            )
        rel = ((f32[FWD_CPU_ROWS].cpu() - cpu).abs().max() / cpu.abs().max()).item()
        bf_rel = norm_rel(bf16, f32)
        finite = bool(torch.isfinite(f32).all() and torch.isfinite(bf16).all())
        part_line(
            "8a", tower=name, shape=[FWD_B, FWD_L, DIM], cpu_rel=rel, cpu_tol=1e-4, bf16_norm_rel=bf_rel,
            bf16_tol=3e-2, finite=finite, all_pad_row_norm=f32[1].norm().item(), seconds=time.perf_counter() - t0,
        )
        if not (rel <= 1e-4 and bf_rel <= 3e-2 and finite):
            raise AssertionError(f"8a {name}: CPU {rel}, bfloat16 {bf_rel}, finite {finite}")


def padded_eval_phase(states: dict, gen) -> dict:
    """8b: score_all_impressions(flat_tokens=False) over bench.py's
    build_workload for each tower, float32, batches sized by
    estimate_tower_batch (at most TrainConfig's 512): the main-path run (the
    launch counts set to 0 just before and read just after, timed, the peak
    memory against tower_activation_bytes at that batch and the largest
    bucket), then a profiled run (the device's busy share). The padding
    share is the padded tokens the tower runs over the real ones. The
    latent tower's padded scores must match its flat eval capped at the
    largest bucket within 1e-5."""
    work = build_workload(np.random.default_rng(SEED))
    hist_lens, _, hist_rev, cand_rev, cand_row, _ = work
    cap = HISTORY_BUCKETS[-1]
    real = int(np.minimum(hist_lens, cap).sum())
    emb = torch.randn((NUM_NEWS, DIM), device="cuda", generator=gen)
    emb = emb / torch.linalg.norm(emb, dim=1, keepdim=True)
    record = {}
    for kind in PADDED_KINDS:
        cfg = TowerConfig(kind=kind)
        tower = padded_tower(kind, states[kind], "cuda")
        batch = min(PADDED_B, estimate_tower_batch(cfg, cap, device="cuda"))
        plan = _bucket_plan(hist_lens, HISTORY_BUCKETS, batch)
        padded = sum(len(starts) * length for length, _, starts, _, _ in plan)

        def run():
            return score_all_impressions(tower, emb, hist_rev, hist_lens, cand_rev, cand_row, batch_size=batch)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_launches()
        t0 = time.perf_counter()
        scores = run()
        seconds = time.perf_counter() - t0
        launches = kernel_launches()
        shapes = {k: collections.Counter({(s, torch.float32): n for s, n in v["wrapper"].shapes.items()})
                  for k, v in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() - base
        prof = profile_call(f"{kind} padded eval", run, top=8)
        fields = dict(
            tower=kind, batch=batch, rows=FLAT_ROWS, seconds=seconds, impressions_per_s=FLAT_ROWS / seconds,
            peak_gb=peak / 1e9, model_gb=tower_activation_bytes(cfg, batch, cap) / 1e9,
            busy_share=prof["busy_ms"] / prof["wall_ms"], padded_tokens=padded, real_tokens=real,
            padding_share=padded / real, launches=launches,
        )
        if not (scores.shape == (len(cand_rev),) and np.isfinite(scores).all()):
            raise AssertionError(f"8b {kind}: scores of shape {scores.shape}, finite {np.isfinite(scores).all()}")
        if kind == "latent":
            flat = FlatEvalPlan(
                hist_rev, hist_lens, cand_rev, cand_row,
                chunk_tokens=estimate_flat_chunk(cfg, device="cuda"), max_len=cap,
            ).score(tower, emb)
            fields.update(flat_max_diff=float(np.abs(flat - scores).max()), flat_tol=1e-5)
            if min(launches.values()) < 1 or not fields["flat_max_diff"] <= 1e-5:
                raise AssertionError(f"8b latent: launches {launches}, padded vs flat {fields['flat_max_diff']}")
            record = dict(launches=launches, shapes=shapes)
        part_line("8b", **fields)
        del tower
        torch.cuda.empty_cache()
    return record


# Leaves whose gradient is 0 but for rounding: the readout's bias adds the
# same to every token's weight of a dimension, which its normalisation over
# the history cancels. No norm-relative error exists there; both devices'
# gradients are held under ZERO_TOL in norm, as the CPU tests hold them.
ZERO_LEAVES = {"transformer": ("linear1.bias",)}
ZERO_TOL = 1e-6
RELU_LAYERS = (1, 2, 4)  # final_attention's linears whose output goes through a ReLU


def relu_flips(state: dict, batch: tuple, emb: torch.Tensor, emb_cpu: torch.Tensor) -> dict:
    """final_attention's real tokens whose ReLU input (after linear1, linear2,
    linear4) has another sign on the card than on the CPU, as {layer: [B, L]
    bool}: at each such token one term of the gradient sums of that linear
    and every linear before it is in on one device and out on the other."""
    signs = []
    for dev, table in (("cuda", emb), ("cpu", emb_cpu)):
        tower = padded_tower("final_attention", state, dev, dropout_rate=0.0)
        idx, mask = (torch.from_numpy(a).to(dev) for a in batch[:2])
        with torch.no_grad():
            z1 = dense(tower.linear1, table[idx.long()] * mask[..., None], torch.float32)
            z2 = dense(tower.linear2, F.relu(z1), torch.float32)
            z4 = dense(tower.linear4, dense(tower.linear3, F.relu(z2), torch.float32), torch.float32)
        signs.append([(z > 0).cpu() for z in (z1, z2, z4)])
    real = torch.from_numpy(batch[1]) > 0
    return {j: (a != b).any(-1) & real for j, a, b in zip(RELU_LAYERS, *signs)}


def step_grads(kind: str, state: dict, batch: tuple, emb: torch.Tensor, emb_cpu: torch.Tensor, margin: float):
    """One padded margin step's loss and gradients ({name: tensor} on the
    host) on the card and on the CPU, dropout off."""
    losses, grads = {}, {}
    for dev, table in (("cuda", emb), ("cpu", emb_cpu)):
        tower = padded_tower(kind, state, dev, dropout_rate=0.0)
        loss = padded_margin_loss(tower, table, on(batch, dev), margin)
        loss.backward()
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad.detach().cpu() for n, p in tower.named_parameters() if p.grad is not None}
        del tower, loss
    return losses, grads


def leaf_gaps(grads: dict, names) -> dict:
    """The norm-relative gap of each named leaf between the card and the CPU."""
    return {n: norm_rel(grads["cuda"][n], grads["cpu"][n]) for n in names}


def padded_check_phase(states: dict, emb: torch.Tensor) -> None:
    """8c.1: one padded margin step per tower at B=64 (histories end-aligned
    into 32 clicks), dropout off: the loss on the card within 1e-5 of the
    CPU's, all parameters' gradients as one vector and each parameter's
    within a norm-relative 1e-4, with two exceptions, each reported:

    - ``ZERO_LEAVES``, whose gradient is 0 but for rounding, are held under
      ``ZERO_TOL`` in norm on both devices;
    - where final_attention has a ReLU input at zero, of one sign on the card
      and the other on the CPU, that token's term of the linear's gradient
      and of every earlier linear's is in on one device and out on the other
      (one term of about 2,000). On the batch itself only the leaves that no
      such flip feeds are held each to 1e-4; then the flipped tokens are
      masked out (final_attention is per token up to its readout, so the
      other tokens' values do not move), no flip may remain, and every leaf
      is held to 1e-4.

    Then two runs of 5 steps (margin and InfoNCE in turn) with dropout on,
    masks from one seeded CUDA generator, give the same parameter bits."""
    rng = np.random.default_rng(SEED + 83)
    T, total, flat = flat_inputs(CHECK_B, rng)
    L, batch = padded_from_flat(flat, total, CHECK_L)
    nce = batch[:4] + (rng.integers(0, NUM_NEWS, (CHECK_B, TRAIN_K)).astype(np.int32),) + batch[5:]
    emb_cpu = emb.cpu()
    margin = TrainConfig().margin
    for kind in PADDED_KINDS:
        t0 = time.perf_counter()
        losses, grads = step_grads(kind, states[kind], batch, emb, emb_cpu, margin)
        zero = ZERO_LEAVES.get(kind, ())
        whole = norm_rel(torch.cat([grads["cuda"][n].flatten() for n in grads["cpu"]]),
                         torch.cat([g.flatten() for g in grads["cpu"].values()]))
        gap = abs(losses["cuda"] - losses["cpu"])
        zero_norms = {n: max(grads[d][n].norm().item() for d in grads) for n in zero}
        fields, ok = {}, gap <= LOSS_TOL and whole <= GRAD_TOL and all(v < ZERO_TOL for v in zero_norms.values())
        flips = relu_flips(states[kind], batch, emb, emb_cpu) if kind == "final_attention" else {}
        fed = max([j for j, f in flips.items() if f.any()], default=0)
        held = [n for n in grads["cpu"] if n not in zero and not (n.startswith("linear") and int(n[6]) <= fed)]
        gaps = leaf_gaps(grads, held)
        worst = max((v, n) for n, v in gaps.items())
        ok = ok and worst[0] <= GRAD_TOL
        if flips:
            flipped = torch.stack(list(flips.values())).any(0).numpy()
            reduced = (batch[0], batch[1] * ~flipped) + batch[2:]
            left = sum(int(f.sum()) for f in relu_flips(states[kind], reduced, emb, emb_cpu).values())
            r_losses, r_grads = step_grads(kind, states[kind], reduced, emb, emb_cpu, margin)
            r_worst = max((v, n) for n, v in leaf_gaps(r_grads, r_grads["cpu"]).items())
            fields = dict(
                flipped_tokens=int(flipped.sum()), flips_left=left, flips_masked_loss_gap=abs(r_losses["cuda"] - r_losses["cpu"]),
                flips_masked_worst_leaf_norm_rel=r_worst[0], flips_masked_worst_leaf=r_worst[1],
            )
            ok = ok and left == 0 and fields["flips_masked_loss_gap"] <= LOSS_TOL and r_worst[0] <= GRAD_TOL
        finals = []
        for _ in range(2):
            tower = padded_tower(kind, states[kind], "cuda")
            opt = make_optimizer(TrainConfig(), tower.parameters())
            drops = torch.Generator(device="cuda").manual_seed(SEED)
            args = on(batch, "cuda"), on(nce, "cuda")
            for i in range(5):
                if i % 2:
                    apply_step(opt, padded_infonce_loss(tower, emb, args[1], drops))
                else:
                    apply_step(opt, padded_margin_loss(tower, emb, args[0], margin, drops))
            torch.cuda.synchronize()
            finals.append([p.detach().clone() for p in tower.parameters()])
        same = all(torch.equal(a, b) for a, b in zip(*finals))
        part_line(
            "8c.1", tower=kind, B=CHECK_B, L=L, loss_card=losses["cuda"], loss_cpu=losses["cpu"], loss_gap=gap,
            loss_tol=LOSS_TOL, grad_norm_rel=whole, grad_tol=GRAD_TOL, leaves_held=len(held),
            leaves=len(grads["cpu"]), worst_leaf_norm_rel=worst[0], worst_leaf=worst[1],
            relu_sign_flips={f"linear{j}": int(f.sum()) for j, f in flips.items()}, zero_leaf_norms=zero_norms,
            zero_tol=ZERO_TOL, **fields, five_steps_bit_identical=same, seconds=time.perf_counter() - t0,
        )
        if not (ok and same):
            raise AssertionError(f"8c.1 {kind}: loss {gap}, gradient {whole}, worst leaf {worst}, {fields}, "
                                 f"zero leaves {zero_norms}, bit-identical {same}")


def padded_step_phase(states: dict, emb: torch.Tensor, runs=None, part: str = "8c.2") -> dict:
    """8c.2 (14c with other ``runs``): 5 timed padded margin steps per
    (tower, compute type) of ``runs`` (default every tower in float32) at
    B=512 (TrainConfig's batch; no dedup, the worst case), dropout on, each
    step a new batch of flat_inputs's histories padded to its own bucket,
    after a warm-up step, the loss fetched every step: ms/step, pairs/s, the
    peak memory against the memory model (``tower_activation_bytes`` at the
    widest step x ``TRAIN_MULTIPLIER``), the device time by part, host syncs
    a step. Returns each run's figures, launches and launches by shape, the
    launches counted from 0 over its timed steps."""
    rng = np.random.default_rng(SEED + 84)
    widths, batches = [], []
    for _ in range(1 + TRAIN_STEPS):
        _, total, flat = flat_inputs(PADDED_B, rng)
        L, b = padded_from_flat(flat, total)
        widths.append(L)
        batches.append(on(b, "cuda"))
    by_l = dict(sorted(collections.Counter(widths[1:]).items()))
    margin = TrainConfig().margin
    out = {}
    for kind, compute in runs or [(k, "float32") for k in PADDED_KINDS]:
        tower = padded_tower(kind, states[kind], "cuda", compute)
        opt = make_optimizer(TrainConfig(), tower.parameters())
        drops = torch.Generator(device="cuda").manual_seed(SEED)

        def step(b):
            return float(apply_step(opt, padded_margin_loss(tower, emb, b, margin, drops)))

        r = timed_steps(step, batches, 1, getattr(torch, compute))
        label = f"{part} {kind}" + ("" if compute == "float32" else f" {compute}")
        split = step_split(opt, lambda: padded_margin_loss(tower, emb, batches[-1], margin, drops), label)
        syncs = count_syncs(lambda: step(batches[-1]))
        model = tower_activation_bytes(TowerConfig(kind=kind, compute_dtype=compute), PADDED_B, max(widths))
        figures = dict(ms_per_step=r["ms"], pairs_per_s=PADDED_B * 1e3 / r["ms"], peak_gb=r["peak_gb"],
                       memory_model_gb=model * TRAIN_MULTIPLIER / 1e9, device_ms_by_part=split)
        part_line(part, tower=kind, compute=compute, B=PADDED_B, steps_by_L=by_l, **figures,
                  host_syncs_per_step=syncs, loss_first=r["losses"][0], loss_last=r["losses"][-1])
        if not (np.isfinite(r["losses"]).all() and syncs == 1):
            raise AssertionError(f"{label}: losses {r['losses']}, {syncs} host syncs a step")
        if kind == "latent" and min(r["launches"].values()) < TRAIN_STEPS:
            raise AssertionError(f"{label}: the latent steps launched {r['launches']}")
        out[(kind, compute)] = dict(figures, launches=r["launches"], shapes=r["shapes"])
        del tower, opt
        torch.cuda.empty_cache()
    return out


def compare_histories(part: str, label: str, card: list, cpu: list) -> None:
    """Epoch by epoch, card against CPU with the CPU tests' tolerances."""
    worst_loss = worst_metric = 0.0
    for got, want in zip(card, cpu, strict=True):
        worst_loss = max(worst_loss, abs(got["loss"] - want["loss"]) / abs(want["loss"]))
        worst_metric = max(worst_metric, *(abs(got["val"][k] - want["val"][k]) for k in METRIC_KEYS))
    part_line(
        part, trainer=label, epochs=len(card), loss_rel=worst_loss, loss_tol=EPOCH_LOSS_REL,
        metric_abs=worst_metric, metric_tol=EPOCH_METRIC_ABS, val_auc=[h["val"]["auc"] for h in card],
    )
    if not (worst_loss <= EPOCH_LOSS_REL and worst_metric <= EPOCH_METRIC_ABS):
        raise AssertionError(f"{part} {label}: card and CPU differ: loss {worst_loss}, metrics {worst_metric}")


SMALL_PADDED = dict(reduced_dim=64, embedding_dim=64, hidden_dim=128, num_layers=1, dropout_rate=0.0)
FIXTURE_TRAIN = dict(learning_rate=3e-4, num_epochs=2, batch_size=128, seed=0)


def padded_fixture_phase() -> None:
    """8c.3: TowerTrainer(flat_train=False, flat_eval=False) on bench.py's
    trained-metrics fixture (d=64, 600/200 rows, 2 epochs), final_attention
    and transformer, on the card against the CPU."""
    ct, cv, emb_t, emb_v = learnable_split(800, 600, 64, seed=7)
    states = tower_states(SMALL_PADDED, seed=0)
    for kind in ("final_attention", "transformer"):
        histories = {}
        for dev in ("cuda", "cpu"):
            trainer = TowerTrainer(
                padded_tower(kind, states[kind], dev, **SMALL_PADDED), ct, emb_t, compiled_val=cv,
                news_emb_val=emb_v, cfg=TrainConfig(**FIXTURE_TRAIN), flat_train=False, flat_eval=False, device=dev,
            )
            histories[dev] = trainer.train()
        compare_histories("8c.3", kind, histories["cuda"], histories["cpu"])


def held_loss(tower, table, batch, margin: float) -> float:
    with torch.no_grad():
        return padded_margin_loss(tower, table, batch, margin).item()


def padded_epoch_phase(states: dict) -> None:
    """8c.4: one full-width epoch per tower on the learnable fixture (10,000
    train rows, batch 2048, margin, the padded step and eval): pairs/s end
    to end, the loss of one fixed batch of train pairs (drawn by another
    sampler seed) before and after it, which must fall, and the val
    metrics."""
    ct, cv, emb_t, emb_v = learnable_split(LEARN_ROWS, LEARN_TRAIN, DIM, seed=7)
    pairs = margin_pairs(ct)
    cfg = TrainConfig(batch_size=TRAIN_B, num_epochs=1, seed=0)
    for kind in PADDED_KINDS:
        tower = padded_tower(kind, states[kind], "cuda")
        trainer = TowerTrainer(
            tower, ct, emb_t, compiled_val=cv, news_emb_val=emb_v, cfg=cfg, flat_train=False, flat_eval=False
        )
        probe = TowerTrainer(tower, ct, emb_t, cfg=dataclasses.replace(cfg, seed=1), flat_train=False, flat_eval=False)
        held = on(next(probe._epoch_batches()), "cuda")
        before = held_loss(tower, probe.news_emb_train, held, cfg.margin)
        t0 = time.perf_counter()
        loss = trainer.train_one_epoch()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = held_loss(tower, probe.news_emb_train, held, cfg.margin)
        t1 = time.perf_counter()
        _, val = trainer.evaluate()
        part_line(
            "8c.4", tower=kind, pairs=pairs, seconds=seconds, pairs_per_s=pairs / seconds, epoch_loss=loss,
            held_loss_before=before, held_loss_after=after, eval_seconds=time.perf_counter() - t1, val=val,
        )
        if not (np.isfinite(loss) and after < before and all(0.0 <= val[k] <= 1.0 for k in METRIC_KEYS)):
            raise AssertionError(f"8c.4 {kind}: loss {loss}, held loss {before} -> {after}, val {val}")
        del tower, trainer, probe
        torch.cuda.empty_cache()


def head_and_blend(dim: int, rng: np.random.Generator) -> tuple:
    head = ClassificationHead(dim, dim)
    head.load_state_dict(classification_head_state_dict_from_jax(random_classification_head_params(rng, dim, dim)))
    blend, reduce = WeightedSumModel(), ReducingModel(dim, dim)
    blend.load_state_dict(weighted_sum_state_dict_from_jax(random_weighted_sum_params(rng)))
    reduce.load_state_dict(reducing_state_dict_from_jax(random_reducing_params(rng, dim, dim)))
    return head, blend, reduce


def joint_phase() -> None:
    """8d: ClassificationTrainer, then JointTowerTrainer blending the tower's
    cosine with that scorer's baseline and reducing both tables. On
    bench.py's fixture (d=64, final_attention, 2 epochs) on the card against
    the CPU, both joint runs on the card scorer's baseline; then at full
    width (the transformer tower) one epoch each on the learnable fixture:
    pairs/s end to end and the val metrics."""
    ct, cv, emb_t, emb_v = learnable_split(800, 600, 64, seed=7)
    state = tower_states(SMALL_PADDED, seed=0)["final_attention"]
    runs = {}
    for dev in ("cuda", "cpu"):
        head, blend, reduce = head_and_blend(64, np.random.default_rng(SEED + 85))
        clf = ClassificationTrainer(
            head, ct, emb_t, compiled_val=cv, news_emb_val=emb_v, cfg=TrainConfig(**FIXTURE_TRAIN), device=dev
        )
        runs[dev] = {"classification": clf.train()}
        if dev == "cuda":
            base = clf.baseline_scores(emb_t), clf.baseline_scores(emb_v)
        joint = JointTowerTrainer(
            padded_tower("final_attention", state, dev, **SMALL_PADDED), ct, emb_t, blend=blend, reduce=reduce,
            baseline_train=base[0], baseline_val=base[1], compiled_val=cv, news_emb_val=emb_v,
            cfg=TrainConfig(**FIXTURE_TRAIN), flat_eval=False, device=dev,
        )
        runs[dev]["joint"] = joint.train()
    for name in ("classification", "joint"):
        compare_histories("8d", name, runs["cuda"][name], runs["cpu"][name])

    ct, cv, emb_t, emb_v = learnable_split(LEARN_ROWS, LEARN_TRAIN, DIM, seed=7)
    head, blend, reduce = head_and_blend(DIM, np.random.default_rng(SEED + 86))
    cfg = TrainConfig(batch_size=TRAIN_B, num_epochs=1, seed=0)
    clf = ClassificationTrainer(head, ct, emb_t, compiled_val=cv, news_emb_val=emb_v, cfg=cfg)
    timed_epoch("classification", clf, margin_pairs(ct))
    joint = JointTowerTrainer(
        padded_tower("transformer", tower_states()["transformer"], "cuda"), ct, emb_t, blend=blend, reduce=reduce,
        baseline_train=clf.baseline_scores(emb_t), baseline_val=clf.baseline_scores(emb_v),
        compiled_val=cv, news_emb_val=emb_v, cfg=cfg, flat_eval=False,
    )
    timed_epoch("joint", joint, margin_pairs(ct))


def margin_pairs(ct) -> int:
    """The margin sampler's pairs an epoch: per impression the larger of its
    positives and negatives."""
    pos = np.bincount(ct.imp_row[ct.labels_flat == 1], minlength=ct.num_rows)
    return int(np.maximum(pos, ct.imp_lens - pos).sum())


def timed_epoch(name: str, trainer, pairs: int) -> None:
    """8d at full width: one epoch, pairs/s end to end, then the eval."""
    t0 = time.perf_counter()
    loss = trainer.train_one_epoch()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _, val = trainer.evaluate()
    part_line("8d", trainer=name, width=DIM, pairs=pairs, seconds=seconds, pairs_per_s=pairs / seconds,
              epoch_loss=loss, val=val)
    if not (np.isfinite(loss) and all(0.0 <= val[k] <= 1.0 for k in METRIC_KEYS)):
        raise AssertionError(f"8d {name}: loss {loss}, val {val}")


def padded_serve_phase(states: dict, work_dir: Path, requests: list) -> None:
    """8e: Ranker (through cli.serve.build_ranker, as ``nrtorch-serve
    --tower`` builds it) with final_attention and with transformer at full
    width over phase 4's 64 MIND-like requests: requests/s of three timed
    rank_batch runs; every request's ranking in the CPU ranker's order and
    its scores within 1e-5."""
    for kind in ("final_attention", "transformer"):
        ckpt = work_dir / f"{kind}.pt"
        torch.save(states[kind], ckpt)
        cfg = TowerConfig(kind=kind, **tower_kwargs_for_dim(DIM))  # as nrtorch-serve --tower KIND --dim DIM
        ranker = build_ranker(work_dir / "emb", "MINDsmall_dev", ckpt, cfg, device="cuda")
        got = ranker.rank_batch(requests)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ranker.rank_batch(requests)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        want = build_ranker(work_dir / "emb", "MINDsmall_dev", ckpt, cfg, device="cpu").rank_batch(requests)
        same_order = all([c for c, _ in g] == [c for c, _ in w] for g, w in zip(got, want, strict=True))
        diff = max(abs(a - b) for g, w in zip(got, want) for (_, a), (_, b) in zip(g, w))
        for (_, cands), ranked in zip(requests, got):
            check_ranked(ranked, cands)
        part_line(
            "8e", tower=kind, requests=len(requests), requests_per_s=[len(requests) / t for t in times],
            same_order=same_order, max_score_diff=diff, tol=1e-5,
        )
        if not (same_order and diff <= 1e-5):
            raise AssertionError(f"8e {kind}: order {same_order}, score difference {diff}")


def padded_phase(gen, work_dir: Path, requests: list) -> dict:
    """Phase 8 (8a-8e), each part's wall time printed; returns the latent
    tower's kernel launches and shapes on the padded eval and the padded
    train steps."""
    states = tower_states()
    seconds = {}

    def timed(part: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[part] = time.perf_counter() - t0
        return out

    timed("8a", padded_forward_phase, states)
    evals = timed("8b", padded_eval_phase, states, gen)
    emb = torch.randn((NUM_NEWS, DIM), device="cuda", generator=gen)
    timed("8c.1", padded_check_phase, states, emb)
    steps = timed("8c.2", padded_step_phase, states, emb)
    del emb
    torch.cuda.empty_cache()
    timed("8c.3", padded_fixture_phase)
    timed("8c.4", padded_epoch_phase, states)
    timed("8d", joint_phase)
    timed("8e", padded_serve_phase, states, work_dir, requests)
    log(json.dumps({"part": "8 wall seconds", **seconds}))
    return dict(eval=evals, train=steps[("latent", "float32")], steps=steps, states=states)


# ---------------------------------------------------------------------------
# Phase 9: the end-to-end token-level path (config[2]) on the card
# ---------------------------------------------------------------------------

# e2e_bench.py's store rule (token lengths geometric with mean 24, clipped
# to 2-64; states N(0, 0.3^2)) at MIND-small's news count, and its fixed
# batch: M distinct news of T tokens, B pairs over histories of L.
E2E_T = 64
E2E_M, E2E_B, E2E_L = 2048, 1024, 64
E2E_CHECK_M, E2E_CHECK_B = 256, 64
# run_config2's tower at dim=1024: 16 latents, 8 heads x 256, GEGLU 4,096.
E2E_TOWER = TowerConfig(kind="latent", reduced_dim=DIM, num_latents=min(16, DIM), latent_dim_head=max(8, DIM // 4))
E2E_STEPS = 5
E2E_STREAMED_NEWS = 16_384  # 9d's streamed route: its first news (reduced for the smoke's time, PERF.md §4)
# 9e's rows: build_workload's draws over the store's news (about 35 margin
# pairs a row, so about one row a step of 32 pairs).
E2E_ROWS = 256
E2E_MODULES = ("token_encoder", "tower")


def e2e_store(gen) -> TokenStore:
    """9a: the token lengths from a numpy seed, the states drawn on the card
    and copied to the host."""
    rng = np.random.default_rng(SEED + 9)
    lens = np.clip(rng.geometric(1 / 24.0, size=NUM_NEWS), 2, E2E_T).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    states = (torch.randn((int(offsets[-1]), DIM), device="cuda", generator=gen) * 0.3).cpu().numpy()
    return TokenStore(states=states, offsets=offsets)


def e2e_state() -> dict:
    """Full-width end-to-end weights (a TokenAttentionPool of one layer and
    run_config2's tower) from a numpy seed, as a state_dict."""
    return e2e_state_dict_from_jax(random_e2e_params(np.random.default_rng(SEED + 9), DIM, 1, E2E_TOWER))


def e2e_model(state: dict, device, dropout: bool = True, compute: str = "float32") -> torch.nn.ModuleDict:
    tower = build_tower(dataclasses.replace(E2E_TOWER, compute_dtype=compute))
    model = torch.nn.ModuleDict({"token_encoder": TokenAttentionPool(DIM, 1), "tower": tower})
    model.load_state_dict(state)
    if not dropout:
        for layer in model["token_encoder"].encoder.layer:
            layer.dropout_rate = layer.g_mlp.dropout_rate = 0.0
    return model.to(device)


def e2e_batch(store: TokenStore, rng: np.random.Generator, m: int, b: int, k: int = 0, streamed: bool = True) -> dict:
    """e2e_bench.py's batch content: m distinct news (sorted), histories of
    E2E_L indices into them at half density (slot 0 always live), one pair
    per history, a positive and a negative (k > 0: k negatives) each. The
    streamed form holds the [m, T, D] block, the gathered one the [m, T]
    index grid into the flat states (built only where ``streamed``)."""
    uniq = np.sort(rng.choice(store.num_items, size=m, replace=False))
    hist_idx = rng.integers(0, m, (b, E2E_L)).astype(np.int32)
    hist_mask = (rng.random((b, E2E_L)) < 0.5).astype(np.float32)
    hist_mask[:, 0] = 1.0
    neg = rng.integers(0, m, (b, k) if k else b).astype(np.int32)
    tail = (hist_idx, hist_mask, np.arange(b, dtype=np.int32), rng.integers(0, m, b).astype(np.int32), neg,
            np.ones(b, np.float32))
    out = dict(gathered=store.padded_index_batch(uniq, E2E_T, max_len=E2E_T) + tail)
    if streamed:
        states, mask = store.gather_padded(uniq, max_len=E2E_T)
        states = np.pad(states, ((0, 0), (0, E2E_T - states.shape[1]), (0, 0)))
        mask = np.pad(mask, ((0, 0), (0, E2E_T - mask.shape[1])))
        out["streamed"] = (states, mask) + tail
    return out


def e2e_loss(model, batch, loss: str, flat_states=None, generator=None):
    enc, tower = model["token_encoder"], model["tower"]
    margin = TrainConfig().margin
    if flat_states is not None:
        if loss == "infonce":
            return e2e_infonce_loss_gathered(enc, tower, flat_states, batch, generator)
        return e2e_margin_loss_gathered(enc, tower, flat_states, batch, margin, generator)
    if loss == "infonce":
        return e2e_infonce_loss(enc, tower, batch, generator)
    return e2e_margin_loss(enc, tower, batch, margin, generator)


def e2e_store_phase(gen) -> tuple[TokenStore, torch.Tensor]:
    """9a: the store, its size, the memory model's verdict and its upload
    (EndToEndTrainer's, in pieces) to the card."""
    t0 = time.perf_counter()
    store = e2e_store(gen)
    made = time.perf_counter() - t0
    tokens = int(store.offsets[-1])
    fits = fits_device_token_store(tokens, DIM, 4, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dev = _upload_states(store.states, torch.device("cuda"))
    torch.cuda.synchronize()
    upload = time.perf_counter() - t1
    part_line(
        "9a", news=store.num_items, tokens=tokens, tokens_per_news=tokens / store.num_items, dim=DIM,
        store_gb=store.states.nbytes / 1e9, fits_device_token_store=fits, made_seconds=made,
        upload_seconds=upload, upload_gb_per_s=store.states.nbytes / upload / 1e9,
        resident_gb=dev.numel() * dev.element_size() / 1e9,
    )
    if not fits or dev.shape != store.states.shape:
        raise AssertionError(f"9a: the store ({tokens} tokens) does not fit the card's share: {fits}")
    return store, dev


def e2e_check_phase(store: TokenStore, dev_states: torch.Tensor, state: dict) -> None:
    """9b: full width, one small batch (M=256, T=64, B=64, L=64), dropout
    off: margin and InfoNCE's loss and every gradient of both modules on the
    card against the CPU (1e-5, norm-relative 1e-4), both kernels launched;
    then dropout on, 5 margin steps from one state on the resident store and
    on the streamed block give the same bits, and a second resident run
    repeats them."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 91)
    batches = {
        "margin": e2e_batch(store, rng, E2E_CHECK_M, E2E_CHECK_B),
        "infonce": e2e_batch(store, rng, E2E_CHECK_M, E2E_CHECK_B, TRAIN_K),
    }
    for loss, b in batches.items():
        losses, grads = {}, {}
        for dev in ("cuda", "cpu"):
            model = e2e_model(state, dev, dropout=False)
            zero_launches()
            value = e2e_loss(model, on(b["streamed"], dev), loss)
            value.backward()
            if dev == "cuda":
                torch.cuda.synchronize()
                launched = kernel_launches()
            losses[dev] = value.item()
            grads[dev] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
            del model, value
        worst = {m: max((norm_rel(grads["cuda"][n], g), n) for n, g in grads["cpu"].items() if n.startswith(m))
                 for m in E2E_MODULES}
        gap = abs(losses["cuda"] - losses["cpu"])
        part_line(
            "9b", loss=loss, M=E2E_CHECK_M, T=E2E_T, B=E2E_CHECK_B, L=E2E_L, loss_card=losses["cuda"],
            loss_cpu=losses["cpu"], loss_diff=gap, loss_tol=LOSS_TOL,
            worst_grad_norm_rel={m: w[0] for m, w in worst.items()},
            worst_leaf={m: w[1] for m, w in worst.items()}, grad_tol=GRAD_TOL, launches=launched,
        )
        if not (gap <= LOSS_TOL and max(w[0] for w in worst.values()) <= GRAD_TOL and min(launched.values()) >= 1):
            raise AssertionError(f"9b {loss}: card and CPU differ (loss {gap}, gradients {worst}) or {launched}")
    b = batches["margin"]
    runs = {}
    for name, resident in (("streamed", False), ("resident", True), ("resident again", True)):
        model = e2e_model(state, "cuda")
        opt = make_optimizer(TrainConfig(), model.parameters())
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        args = on(b["gathered" if resident else "streamed"], "cuda")
        flat = dev_states if resident else None
        losses = [float(apply_step(opt, e2e_loss(model, args, "margin", flat, gen))) for _ in range(E2E_STEPS)]
        runs[name] = (losses, [p.detach().clone() for p in model.parameters()])
        del model, opt
    same_routes = runs["streamed"][0] == runs["resident"][0] and all(
        torch.equal(a, c) for a, c in zip(runs["streamed"][1], runs["resident"][1]))
    same_runs = runs["resident"][0] == runs["resident again"][0] and all(
        torch.equal(a, c) for a, c in zip(runs["resident"][1], runs["resident again"][1]))
    part_line(
        "9b", steps=E2E_STEPS, dropout=0.1, losses=runs["resident"][0],
        resident_and_streamed_bit_identical=same_routes, two_runs_bit_identical=same_runs,
        seconds=time.perf_counter() - t0,
    )
    if not (same_routes and same_runs):
        raise AssertionError(f"9b: resident vs streamed {same_routes}, run vs run {same_runs}")


def e2e_step_split(model, opt, args, loss: str, flat, gen, label: str) -> dict:
    """One e2e step's device time by part, each under the profiler with a
    synchronize after it: the token encoder's forward (with the gather from
    the resident store); the rest of the forward (the tower: our kernels,
    cuBLAS, the rest); the whole backward (GEMMs, the rest); the optimizer
    on CUDA events."""
    optimizer_ms = []

    def encode():
        states = args[0] if flat is None else gathered_token_states(flat, args[0], args[1])
        return model["token_encoder"](states, args[1], generator=gen)

    def run():
        news, enc, c1 = device_ms_by_kernel(encode)
        encoded = torch.nn.ModuleDict({"token_encoder": _Fixed(news), "tower": model["tower"]})
        value, fwd, c2 = device_ms_by_kernel(lambda: e2e_loss(encoded, args, loss, None, gen))
        parts = [(news, enc, c1), (value, fwd, c2), device_ms_by_kernel(value.backward)]
        optimizer_ms.append(event_ms(lambda: (opt.step(), opt.zero_grad(set_to_none=True))))
        return parts

    parts, tries = profiled_parts(run)
    (_, enc, _), (_, fwd, _), (_, bwd, _) = parts

    split = {
        "token encoder forward": sum(enc.values()),
        "tower forward kernels": part(fwd, ours),
        "tower forward cuBLAS": part(fwd, cublas),
        "tower forward rest": part(fwd, lambda k: not ours(k) and not cublas(k)),
        "backward GEMMs": part(bwd, cublas),
        "backward rest": part(bwd, lambda k: not cublas(k)),
        "optimizer": optimizer_ms[-1],
    }
    split["total"] = sum(split.values())
    if not split["optimizer"] > 0:
        raise AssertionError(f"{label}: the optimizer's part read {split['optimizer']} ms")
    log(
        f"  {label}: one step's device time by part (ms): "
        + ", ".join(f"{k} {v:.2f} ({v / split['total']:.1%})" for k, v in split.items() if k != "total")
        + f"; total {split['total']:.2f}; profiler's cover of the profiled parts' spans "
        + ", ".join(f"{c:.0%}" for _, _, c in parts) + f" ({tries} tries; the optimizer on CUDA events)"
    )
    for name, times in (("encoder forward", enc), ("tower forward", fwd)):
        for key, ms in sorted(times.items(), key=lambda kv: -kv[1])[:4]:
            log(f"    {name} {ms:9.3f} ms  {key[:100]}")
    return split


class _Fixed(torch.nn.Module):
    """Stands in for the token encoder with vectors already computed, so a
    profile can time the rest of the step alone."""

    def __init__(self, out: torch.Tensor):
        super().__init__()
        self.out = out

    def forward(self, states, mask, generator=None):
        return self.out


def e2e_steps_phase(
    store: TokenStore, dev_states: torch.Tensor, state: dict, card: str, compute: str = "float32",
    routes: tuple = ("resident", "streamed"), part: str = "9c",
) -> dict:
    """9c (14d in bfloat16 on the resident store): e2e_bench.py's batch
    (M=2048, T=64, B=1024, L=64) at full width, the tower in ``compute``
    (the token encoder float32), dropout on, margin and InfoNCE (K=5), each
    on ``routes`` (the resident store, the streamed block): 3 warm-up and 10
    timed steps with the batch copied to the card from pinned memory without
    blocking and the loss fetched every step; ms/step, pairs/s, bytes to the
    card a step, the peak memory, the device time by part, host syncs a
    step, and the host's time to build the streamed block (gather_padded,
    then pinning). Launch counts are set to 0 just before each run's timed
    steps and read just after; their sum, the shapes and each run's figures
    are returned."""
    rng = np.random.default_rng(SEED + 92)
    streamed = "streamed" in routes
    batches = {"margin": e2e_batch(store, rng, E2E_M, E2E_B, streamed=streamed),
               "infonce": e2e_batch(store, rng, E2E_M, E2E_B, TRAIN_K, streamed=streamed)}
    host_ms = {}
    if streamed:
        uniq = np.sort(rng.choice(store.num_items, size=E2E_M, replace=False))
        t0 = time.perf_counter()
        block, _ = store.gather_padded(uniq, max_len=E2E_T)
        host_ms["gather_padded"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        torch.from_numpy(block).pin_memory()
        host_ms["pin_memory"] = (time.perf_counter() - t0) * 1e3
        del block
    launches, shapes, figures = collections.Counter(), {}, {}
    for loss, b in batches.items():
        for route in routes:
            host = tuple(torch.from_numpy(a).pin_memory() for a in b["gathered" if route == "resident" else "streamed"])
            h2d = sum(t.numel() * t.element_size() for t in host)
            flat = dev_states if route == "resident" else None
            model = e2e_model(state, "cuda", compute=compute)
            opt = make_optimizer(TrainConfig(), model.parameters())
            gen = torch.Generator(device="cuda").manual_seed(SEED)

            def step(_=None):
                args = tuple(t.to("cuda", non_blocking=True) for t in host)
                return float(apply_step(opt, e2e_loss(model, args, loss, flat, gen)))

            r = timed_steps(step, [None] * (3 + TRAIN_STEPS), 3, getattr(torch, compute))
            launches.update(r["launches"])
            shapes = add_shapes(shapes, r["shapes"])
            args = tuple(t.to("cuda", non_blocking=True) for t in host)
            split = e2e_step_split(model, opt, args, loss, flat, gen, f"{part} {loss} {route}")
            syncs = count_syncs(step)
            figures[(loss, route)] = dict(ms_per_step=r["ms"], pairs_per_s=E2E_B * 1e3 / r["ms"], peak_gb=r["peak_gb"],
                                          device_ms_by_part=split)
            part_line(
                part, loss=loss, route=route, compute=compute, M=E2E_M, T=E2E_T, B=E2E_B, L=E2E_L,
                ms_per_step=r["ms"], pairs_per_s=E2E_B * 1e3 / r["ms"], h2d_bytes_per_step=h2d,
                peak_gb_above_store_and_weights=r["peak_gb"], device_ms_by_part=split, host_syncs_per_step=syncs,
                loss_first=r["losses"][0], loss_last=r["losses"][-1], streamed_block_host_ms=host_ms, card=card,
            )
            if not np.isfinite(r["losses"]).all():
                raise AssertionError(f"{part} {loss} {route}: losses {r['losses']}")
            del model, opt, args, host
            torch.cuda.empty_cache()
    if min(launches.values()) < 2 * len(routes) * TRAIN_STEPS:
        raise AssertionError(f"{part}: the timed steps launched {dict(launches)}")
    return dict(launches=dict(launches), shapes=shapes, figures=figures)


def e2e_materialize_phase(store: TokenStore, dev_states: torch.Tensor, state: dict) -> np.ndarray:
    """9d: materialize_from_token_store at full width on the resident route
    over the whole store and on the streamed one over its first
    E2E_STREAMED_NEWS news, the batch from the memory model
    (batch_size=None) and max_token_len 64 (run_config2's): news/s, the
    batch picked; the two routes within 1e-6 of each other on the news
    both ran, all finite."""
    enc = e2e_model(state, "cuda")["token_encoder"]
    batch = min(1024, estimate_token_attention_batch(DIM, E2E_T, device="cuda"))
    n = E2E_STREAMED_NEWS
    head = TokenStore(states=store.states[: store.offsets[n]], offsets=store.offsets[: n + 1])
    out = {}
    for route, part_store, flat in (("resident", store, dev_states), ("streamed", head, None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[route] = materialize_from_token_store(enc, part_store, batch_size=None, max_token_len=E2E_T,
                                                  dev_states=flat)
        seconds = time.perf_counter() - t0
        part_line("9d", route=route, news=part_store.num_items, batch=batch, seconds=seconds,
                  news_per_s=part_store.num_items / seconds)
    diff = float(np.abs(out["resident"][:n] - out["streamed"]).max())
    finite = bool(np.isfinite(out["resident"]).all())
    part_line("9d", shape=list(out["resident"].shape), routes_max_diff=diff, compared_news=n, tol=1e-6, finite=finite)
    if not (out["resident"].shape == (store.num_items, DIM) and diff <= 1e-6 and finite):
        raise AssertionError(f"9d: routes differ by {diff}, finite {finite}")
    return out["resident"]


def e2e_config2_phase(store: TokenStore, part: str = "9e") -> dict:
    """9e (and 10c, on the store built from text): configs.run_config2 at
    dim=1024 with its published defaults
    (batch 32, one epoch, max_token_len 64, TrainConfig's lr), device=None,
    over E2E_ROWS of build_workload's rows drawn over the store's news. The
    entry point runs as a user calls it; a subclass of EndToEndTrainer and a
    wrapper of the fused eval stand in for the module's names to read the
    times, the batches' M, T and L, and the launch counts (set to 0 just
    before training and before the eval, read just after each)."""
    seen = dict(shapes=[], pairs=0.0)
    counts = {}

    class Timed(EndToEndTrainer):
        def _epoch_batches(self):
            for b in super()._epoch_batches():
                seen["shapes"].append((b[0].shape[0], b[0].shape[1], b[2].shape[1]))
                seen["pairs"] += float(b[-1].sum())
                yield b

        def train(self, num_epochs=None):
            seen["device_store"] = self.device_store
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            zero_launches()
            t0 = time.perf_counter()
            out = super().train(num_epochs)
            torch.cuda.synchronize()
            seen["train_seconds"] = time.perf_counter() - t0
            seen["train_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
            counts["train"] = _snapshot()
            return out

        def materialize_news_embeddings(self, batch_size=None, store=None):
            t0 = time.perf_counter()
            out = super().materialize_news_embeddings(batch_size, store)
            seen["materialize_seconds"] = time.perf_counter() - t0
            return out

    def fused(*args):
        zero_launches()
        t0 = time.perf_counter()
        out = fused_eval(*args)
        seen["eval_seconds"] = time.perf_counter() - t0
        counts["eval"] = _snapshot()
        return out

    compiled = mind_behaviors(np.random.default_rng(SEED + 93), E2E_ROWS, store.num_items)
    fused_eval = configs_module._fused_eval_metrics
    configs_module.EndToEndTrainer, configs_module._fused_eval_metrics = Timed, fused
    try:
        t0 = time.perf_counter()
        metrics = configs_module.run_config2(compiled, store, DIM)
        seconds = time.perf_counter() - t0
    finally:
        configs_module.EndToEndTrainer, configs_module._fused_eval_metrics = EndToEndTrainer, fused_eval
    m, t, l = (np.array([s[i] for s in seen["shapes"]]) for i in range(3))
    dist = {name: dict(sorted(collections.Counter(a.tolist()).items())) for name, a in (("M", m), ("T", t), ("L", l))}
    part_line(
        part, rows=E2E_ROWS, dim=DIM, batch=32, steps=len(seen["shapes"]), pairs=seen["pairs"],
        device_store=seen["device_store"], train_seconds=seen["train_seconds"],
        pairs_per_s=seen["pairs"] / seen["train_seconds"], steps_by=dist, train_peak_gb=seen["train_peak_gb"],
        materialize_seconds=seen["materialize_seconds"], news_per_s=store.num_items / seen["materialize_seconds"],
        eval_seconds=seen["eval_seconds"], impressions_per_s=E2E_ROWS / seen["eval_seconds"],
        metrics=metrics, seconds=seconds, launches={k: v["launches"] for k, v in counts.items()},
    )
    values = [metrics[k] for k in METRIC_KEYS]
    if not (all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in values)
            and min(counts["train"]["launches"].values()) >= 1 and min(counts["eval"]["launches"].values()) >= 1):
        raise AssertionError(f"{part}: metrics {metrics}, launches {counts}")
    return counts


def _snapshot() -> dict:
    return dict(
        launches=kernel_launches(),
        shapes={k: collections.Counter({(s, torch.float32): n for s, n in v["wrapper"].shapes.items()})
                for k, v in KERNELS.items()},
    )


def e2e_phase(gen, card: str) -> dict:
    """Phase 9 (9a-9e), float32, TF32 off, each part's wall time printed;
    returns the kernels' launches and shapes on the e2e train steps (9c's
    timed steps and 9e's epoch) and on 9e's eval."""
    seconds = {}

    def timed(part: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[part] = time.perf_counter() - t0
        return out

    resolve_device("cuda")  # TF32 off, as every entry point sets it
    state = e2e_state()
    store_state = gen.get_state()  # phase 13's ranks rebuild the store from it
    store, dev_states = timed("9a", e2e_store_phase, gen)
    timed("9b", e2e_check_phase, store, dev_states, state)
    steps = timed("9c", e2e_steps_phase, store, dev_states, state, card)
    # Phase 14d runs here, while the store is resident on the card.
    mixed = timed("14d", mixed_e2e_part, store, dev_states, state, card, steps["figures"])
    materialized = timed("9d", e2e_materialize_phase, store, dev_states, state)
    del dev_states
    torch.cuda.empty_cache()
    counts = timed("9e", e2e_config2_phase, store)
    log(json.dumps({"part": "9 wall seconds", **seconds}))
    train = dict(
        launches=dict(collections.Counter(steps["launches"]) + collections.Counter(counts["train"]["launches"])),
        shapes={k: steps["shapes"][k] + counts["train"]["shapes"][k] for k in KERNELS},
    )
    return dict(train=train, eval=counts["eval"], store_state=store_state, materialized=materialized, mixed=mixed,
                mixed_seconds=seconds["14d"])


# ---------------------------------------------------------------------------
# Phase 10: the news encoder and corpus encoding on the card
# ---------------------------------------------------------------------------

# Card against CPU (10a, 10d): float32 on both within a norm-relative 1e-4
# (float32 sums in other orders over 24 layers); the card in bfloat16, the
# encoder's default compute type, within 3e-2 of the CPU's float32.
ENC_F32_TOL, ENC_BF16_TOL = 1e-4, 3e-2
ENC_MAX_LENGTH = 128  # save_emb's default
# NV-Embed's published config.json (NV-Embed-v2: a Mistral-7B backbone, the
# latent-attention head of 512 latents and 8 heads x 4,096), the backbone cut
# to NV_LAYERS of its 32 layers: the head, which runs the kernels, is whole.
NV_EMBED_HF = {
    "architectures": ["NVEmbedModel"],
    "text_config": {
        "architectures": ["MistralModel"], "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
        "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "sliding_window": 4096, "max_position_embeddings": 32768,
    },
    "latent_attention_config": {"num_latents_value": 512, "num_cross_heads": 8, "cross_dim_head": 4096, "latent_dim": 4096},
}
NV_LAYERS, NV_NEWS, NV_BATCH = 2, 4096, 128
# 10b's corpus and 10c's store (its first STORE_NEWS passages), reduced for
# the smoke's time (PERF.md §4 lists each cut).
ENC_NEWS, STORE_NEWS = 32_768, 16_384
STORE_SUBSET = 4_096  # 10c's news built in RAM and to disk, to split a build's time


class TimedTokenizer:
    """A tokenizer that keeps the host seconds and the arrays of each call."""

    def __init__(self, tok):
        self.tok, self.seconds, self.outputs = tok, [], []

    def __call__(self, texts, max_length=None):
        t0 = time.perf_counter()
        out = self.tok(texts, max_length)
        self.seconds.append(time.perf_counter() - t0)
        self.outputs.append(out)
        return out


def news_texts(n: int, seed: int) -> list[str]:
    """MIND-like title-only news: "Title: " and 12-32 words drawn from a
    20,000-word vocabulary, 15-35 tokens with BOS and EOS."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(12, 33, size=n)
    words = rng.integers(0, 20_000, size=int(counts.sum()))
    ends = np.cumsum(counts)
    return ["Title: " + " ".join(f"w{w}" for w in words[e - c : e]) for c, e in zip(counts, ends)]


def mixed_texts(n: int, seed: int) -> list[str]:
    """n news of mixed lengths, 1 to about 120 words."""
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{w}" for w in rng.integers(0, 20_000, size=int(c))) for c in np.linspace(1, 120, n)]


def cpu_copy(enc: NewsEncoder) -> NewsEncoder:
    """The encoder's float32 twin on the CPU (no init of its own: built on
    the meta device, the card's tensors assigned)."""
    with torch.device("meta"):
        cpu = NewsEncoder(enc.config)
    cpu.load_state_dict({k: v.cpu() for k, v in enc.state_dict().items()}, assign=True)
    return cpu.eval()


def retyped(enc: NewsEncoder, compute_dtype: str) -> NewsEncoder:
    """The same weights (shared, not copied) computing in ``compute_dtype``."""
    with torch.device("meta"):
        other = NewsEncoder(dataclasses.replace(enc.config, compute_dtype=compute_dtype))
    other.load_state_dict(enc.state_dict(), assign=True)
    return other.eval()


def card_vs_cpu(part: str, enc32: NewsEncoder, texts: list[str], tok) -> None:
    """The float32 encoder on the card and on the CPU, and in bfloat16 on the
    card, over ``texts`` (trimmed to their longest): pooled vectors and
    hidden states norm-relative to the CPU's float32, the pooled vectors'
    norms."""
    ids, mask = tok(texts)
    w = int(mask.sum(1).max())
    ids, mask = torch.from_numpy(ids[:, :w]), torch.from_numpy(mask[:, :w])
    t0 = time.perf_counter()
    cpu = cpu_copy(enc32)
    with torch.no_grad():
        want = cpu(ids, mask), cpu.hidden_states(ids, mask)
    cpu_seconds = time.perf_counter() - t0
    del cpu
    errs = {}
    for name, enc in (("float32", enc32), ("bfloat16", retyped(enc32, "bfloat16"))):
        with torch.no_grad():
            got = enc(ids.cuda(), mask.cuda()).cpu(), enc.hidden_states(ids.cuda(), mask.cuda()).cpu()
        live = mask.bool()
        errs[name] = dict(pooled=norm_rel(got[0], want[0]), hidden=norm_rel(got[1][live], want[1][live]),
                          norm_gap=(got[0].norm(dim=-1) - 1).abs().max().item(),
                          finite=bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()))
    part_line(part, check="card vs CPU", news=len(texts), tokens=int(mask.sum()), width=w, cpu_seconds=cpu_seconds,
              errors=errs, tol={"float32": ENC_F32_TOL, "bfloat16": ENC_BF16_TOL})
    ok = all(e["finite"] and e["norm_gap"] <= 1e-5 for e in errs.values())
    ok &= max(errs["float32"]["pooled"], errs["float32"]["hidden"]) <= ENC_F32_TOL
    ok &= max(errs["bfloat16"]["pooled"], errs["bfloat16"]["hidden"]) <= ENC_BF16_TOL
    if not ok:
        raise AssertionError(f"{part}: the card and the CPU disagree: {errs}")


def encoder_e5_phase() -> tuple[NewsEncoder, object]:
    """10a: e5-large at full width and depth (24 layers, D=1,024, 16 heads,
    FFN 4,096, vocab 250,002) from build_encoder with seeded weights and a
    HashTokenizer: 16 news of mixed lengths on the card against the CPU
    (float32, and the card in bfloat16), then the bucketed encode against
    the fixed-width one on the card in float32. Returns the bfloat16
    encoder (EncoderConfig's default) and the tokenizer."""
    t0 = time.perf_counter()
    enc32, tok = build_encoder(encoder_config=EncoderConfig(), max_length=ENC_MAX_LENGTH,
                               compute_dtype="float32", seed=SEED, device="cuda")
    built = time.perf_counter() - t0
    params = sum(p.numel() for p in enc32.parameters())
    part_line("10a", config=dataclasses.asdict(enc32.config), params=params, build_seconds=built)
    texts = mixed_texts(16, SEED + 10)
    card_vs_cpu("10a", enc32, texts, tok)
    ids, mask = tok(texts)
    fixed = encode_corpus(enc32, ids, mask, batch_size=16, device="cuda")
    bucketed = encode_corpus_bucketed(enc32, ids, mask, batch_size=None, device="cuda")
    gap = norm_rel(bucketed, fixed)
    part_line("10a", check="bucketed vs fixed width", lengths=sorted({int(x) for x in mask.sum(1)}), norm_rel=gap,
              tol=ENC_F32_TOL)
    if not gap <= ENC_F32_TOL:
        raise AssertionError(f"10a: the bucketed encode differs from the fixed-width one by {gap}")
    return retyped(enc32, "bfloat16"), tok


def bucket_batches(enc: NewsEncoder, mask: np.ndarray) -> list[tuple[int, int, int]]:
    """(width, rows, batch) of each length bucket encode_corpus_bucketed
    runs with batch_size=None, as it picks them."""
    lens = mask.sum(1)
    widths = tuple(b for b in TOKEN_BUCKETS if b < mask.shape[1]) + (mask.shape[1],)
    assignment = np.searchsorted(np.asarray(widths), lens, side="left")
    out = []
    for bi, w in enumerate(widths):
        rows = int((assignment == bi).sum())
        if rows:
            bs = min(max(1024, 131072 // w), estimate_encoder_batch(enc.config, length=w, device="cuda"))
            out.append((w, rows, max(8, min(bs, 1 << (rows - 1).bit_length()))))
    return out


def corpus_phase(enc: NewsEncoder, tok, texts: list[str]) -> tuple:
    """10b: encode_query_and_passage over the corpus at max_length 128 with
    the buckets and the memory model's batch, bfloat16, as save_emb runs it:
    the host's tokenisation apart, padded tokens a real one, the peak memory
    against the memory model; then the passage and the query encodes timed
    apart (news/s, real tokens/s; the same vectors to the bit), and one
    profiled bucket. Returns the passage tokens."""
    timed_tok = TimedTokenizer(tok)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    query, passage = encode_query_and_passage(enc, timed_tok, texts, QUERY_INSTRUCTION, batch_size=None,
                                              buckets=TOKEN_BUCKETS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    tokens = dict(zip(("passage", "query"), timed_tok.outputs))
    plans = {name: bucket_batches(enc, m) for name, (_, m) in tokens.items()}
    real = {name: int(m.sum()) for name, (_, m) in tokens.items()}
    padded = {name: sum(-(-r // b) * b * w for w, r, b in plan) for name, plan in plans.items()}
    model = max(encoder_activation_bytes(enc.config, b, w) for plan in plans.values() for w, _, b in plan)
    rates = {}
    for name, (ids, mask), again in (("passage", tokens["passage"], passage), ("query", tokens["query"], query)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode_corpus_bucketed(enc, ids, mask, batch_size=None, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rates[name] = dict(seconds=seconds, news_per_s=len(texts) / seconds, real_tokens_per_s=real[name] / seconds,
                           same_bits=bool(torch.equal(out, again)))
        del out
    w, rows, bs = plans["passage"][0]
    ids, mask = tokens["passage"]
    first = np.nonzero(mask.sum(1) <= w)[0]
    prof = profile_call(f"passage bucket of width {w} ({rows} news, batch {bs})", lambda: encode_corpus(
        enc, ids[first, :w], mask[first, :w], batch_size=bs, device="cuda"))
    norms = passage.norm(dim=-1)
    part_line(
        "10b", news=len(texts), max_length=ENC_MAX_LENGTH, wall_seconds=wall,
        tokenize_seconds={"passage": timed_tok.seconds[0], "query": timed_tok.seconds[1]},
        encode_seconds=wall - sum(timed_tok.seconds), buckets=plans, real_tokens=real,
        padded_tokens_per_real={k: padded[k] / real[k] for k in real}, apart=rates,
        busy_share_of_one_bucket=prof["busy_ms"] / prof["wall_ms"], peak_gb=peak / 1e9,
        model_gb_at_largest_batch=model / 1e9,
    )
    ok = query.shape == passage.shape == (len(texts), DIM) and bool(torch.isfinite(query).all())
    ok &= (norms - 1).abs().max().item() <= 1e-3 and all(r["same_bits"] for r in rates.values())
    if not ok:
        raise AssertionError(f"10b: tables {tuple(query.shape)} {tuple(passage.shape)}, norms, or {rates}")
    return tokens["passage"]


def token_store_phase(enc: NewsEncoder, ids: np.ndarray, mask: np.ndarray, work_dir: Path) -> None:
    """10c: build_token_store over the corpus's passages, float16, streamed
    into a directory (news/s, GB written; the first STORE_SUBSET news also
    in RAM and to disk apart, news/s each); 32 stored rows about the bucket
    boundary held against NewsEncoder.hidden_states trimmed: recomputed in
    the batch the store ran them in (float16 rounding apart) and alone at
    their own bucket width (the bfloat16 tolerance); then run_config2 for one
    epoch on the store, as 9e. The directory is deleted at the end."""
    out_dir = work_dir / "text_token_store"
    shutil.rmtree(out_dir, ignore_errors=True)
    batch = 64
    # Where a build's time goes: the first STORE_SUBSET news in RAM and to disk.
    subset = {}
    for route, target in (("ram", None), ("disk", work_dir / "text_token_store_subset")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build_token_store(enc, ids[:STORE_SUBSET], mask[:STORE_SUBSET], batch_size=batch, out_dir=target,
                          store_dtype=np.float16, device="cuda")
        subset[route] = STORE_SUBSET / (time.perf_counter() - t0)
        if target is not None:
            shutil.rmtree(target)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = build_token_store(enc, ids, mask, batch_size=batch, out_dir=out_dir, store_dtype=np.float16,
                              device="cuda")
    seconds = time.perf_counter() - t0
    written = sum(f.stat().st_size for f in out_dir.iterdir())
    lens = mask.sum(1)
    widths = tuple(b for b in TOKEN_BUCKETS if b < mask.shape[1]) + (mask.shape[1],)
    assignment = np.searchsorted(np.asarray(widths), lens, side="left")
    order = np.argsort(assignment, kind="stable")  # the store's row order
    edge = int((assignment == 0).sum())  # where the first bucket ends in it
    positions = range(edge - 16, edge + 16)
    same = {}  # the store's batches about the edge, recomputed as it ran them
    for bi in sorted({q // batch for q in positions}):
        rows = order[bi * batch : (bi + 1) * batch]
        w = int(widths[assignment[rows].max()])
        block = [np.pad(a[rows, :w], ((0, batch - len(rows)), (0, 0))) for a in (ids, mask)]
        with torch.no_grad():
            same[bi] = enc.hidden_states(*(torch.from_numpy(b).cuda() for b in block)).cpu()
    batch_err, alone_err = 0.0, 0.0
    for q in positions:
        r = order[q]
        stored = torch.from_numpy(np.asarray(store.states[store.offsets[r] : store.offsets[r + 1]], np.float32))
        want = same[q // batch][q % batch, : lens[r]]
        batch_err = max(batch_err, ((stored - want).abs() - 2.0**-11 * want.abs()).max().item())
        wr = int(widths[assignment[r]])
        with torch.no_grad():
            alone = enc.hidden_states(*(torch.from_numpy(a[r : r + 1, :wr]).cuda() for a in (ids, mask)))
        alone_err = max(alone_err, norm_rel(stored, alone[0, : lens[r]].cpu()))
    part_line(
        "10c", news=store.num_items, tokens=int(store.offsets[-1]), batch=batch, seconds=seconds,
        news_per_s=store.num_items / seconds, gb_written=written / 1e9, store_dtype="float16",
        subset_news_per_s={"news": STORE_SUBSET, **subset},
        checked_rows=len(positions), bucket_edge=edge,
        widths_checked=sorted({int(widths[assignment[order[q]]]) for q in positions}),
        batch_excess_over_float16_rounding=batch_err, alone_norm_rel=alone_err, alone_tol=ENC_BF16_TOL,
    )
    if not (batch_err <= 1e-6 and alone_err <= ENC_BF16_TOL
            and np.array_equal(store.offsets, np.concatenate([[0], np.cumsum(lens)]))):
        raise AssertionError(f"10c: stored rows differ: batch {batch_err}, alone {alone_err}")
    del same
    e2e_config2_phase(store, part="10c")
    del store
    shutil.rmtree(out_dir)


def nv_embed_phase(texts: list[str]) -> dict:
    """10d: NV-Embed's layout at its published widths (a Mistral-7B backbone
    cut to NV_LAYERS layers, printed as reduced; the head of 512 latents and
    8 heads x 4,096 whole): 8 news on the card against the CPU, then
    encode_corpus_bucketed over NV_NEWS news at batch NV_BATCH in bfloat16
    (the head in float32) with the launch counts set to 0 just before and
    read just after: news/s, both kernels launched."""
    cfg = encoder_config_from_hf(NV_EMBED_HF, num_layers=NV_LAYERS)
    t0 = time.perf_counter()
    enc32, tok = build_encoder(encoder_config=cfg, max_length=ENC_MAX_LENGTH, compute_dtype="float32",
                               seed=SEED + 11, device="cuda")
    built = time.perf_counter() - t0
    part_line("10d", config=dataclasses.asdict(cfg), params=sum(p.numel() for p in enc32.parameters()),
              build_seconds=built, reduced={"num_layers": [NV_LAYERS, NV_EMBED_HF["text_config"]["num_hidden_layers"]]})
    card_vs_cpu("10d", enc32, texts[:8], tok)
    enc = retyped(enc32, cfg.compute_dtype)
    ids, mask = tok(texts[:NV_NEWS])
    encode_corpus_bucketed(enc, ids[:NV_BATCH], mask[:NV_BATCH], batch_size=NV_BATCH, device="cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = encode_corpus_bucketed(enc, ids, mask, batch_size=NV_BATCH, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    shapes = {k: collections.Counter({(s, torch.float32): n for s, n in v["wrapper"].shapes.items()})
              for k, v in KERNELS.items()}
    gap = (out.norm(dim=-1) - 1).abs().max().item()
    part_line("10d", news=NV_NEWS, batch=NV_BATCH, seconds=seconds, news_per_s=NV_NEWS / seconds,
              real_tokens=int(mask.sum()), peak_gb_with_weights=torch.cuda.max_memory_allocated() / 1e9,
              launches=launches,
              shapes={k: {str(s[0]): n for s, n in c.items()} for k, c in shapes.items()}, norm_gap=gap)
    heads = {(b, 8, l, 512, 4096) for (b, h, l, n, dh), _ in shapes["latent_attention"]}
    if not (min(launches.values()) >= 1 and torch.isfinite(out).all() and gap <= 1e-3
            and {s[0] for s in shapes["latent_attention"]} <= heads
            and all(s[0][1:] == (4096, 16384) for s in shapes["geglu"])):
        raise AssertionError(f"10d: launches {launches}, shapes {shapes}, norms {gap}")
    return dict(launches=launches, shapes=shapes)


def encoder_phase(work_dir: Path) -> dict:
    """Phase 10 (10a-10d), each part's wall time printed; returns the
    kernels' launches and shapes on 10d's encode."""
    seconds = {}

    def timed(part: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    resolve_device("cuda")
    enc, tok = timed("10a", encoder_e5_phase)
    texts = news_texts(ENC_NEWS, SEED + 12)
    ids, mask = timed("10b", corpus_phase, enc, tok, texts)
    timed("10c", token_store_phase, enc, ids[:STORE_NEWS], mask[:STORE_NEWS], work_dir)
    del enc
    counts = timed("10d", nv_embed_phase, texts)
    log(json.dumps({"part": "10 wall seconds", **seconds}))
    return counts


# ---------------------------------------------------------------------------
# Phase 11: the pipeline and the CLIs, from MIND's raw TSVs
# ---------------------------------------------------------------------------

# 11a's news and rows, reduced from MIND-small's 65,238 news and 156,965 /
# 73,152 behaviors rows for the smoke's time (PERF.md §4 lists each cut).
PIPE_NEWS = 16_384
PIPE_ROWS = {"MINDsmall_train": 16_384, "MINDsmall_dev": 8_192}
PIPE_ENTITIES = 20_000  # entity vectors a split
CHECK_ROWS = {"MINDsmall_train": 128, "MINDsmall_dev": 64}  # 11e's sample of each split
PIPE_CATEGORIES = ("news", "sports", "finance", "lifestyle", "travel", "video", "foodanddrink", "weather")
# 11d: the eval CLI against the flat eval computed directly (the same scores;
# host float64 metrics against the device's float32 ones); 11e: the card
# against the CPU, metrics and trained weights, norm-relative (the whole
# run is a float32 Adam epoch of each trainer: phases 7-8 reached 1e-6 to
# 3e-6 on single steps and epochs).
EVAL_CLI_TOL, PIPE_CPU_TOL = 1e-5, 1e-4


def write_raw_mind(root: Path, name: str, num_rows: int, seed: int) -> dict:
    """Raw MIND TSVs of ``name`` under ``root/raw/<name>/``: PIPE_NEWS news
    whose titles follow 10b's rule (12-32 words; news_text is then 10b's
    text), nine in ten with an abstract, seven in ten with 1-3 title
    entities; PIPE_ENTITIES entity vectors; ``num_rows`` behaviors rows with
    build_workload's history and impression lengths and labels. Returns the
    counts written."""
    rng = np.random.default_rng(seed)
    raw = root / "raw" / name
    raw.mkdir(parents=True, exist_ok=True)
    ids = np.array([f"N{i}" for i in range(PIPE_NEWS)])
    titles = [t[len("Title: "):] for t in news_texts(PIPE_NEWS, seed)]
    n_ents = np.where(rng.random(PIPE_NEWS) < 0.7, rng.integers(1, 4, PIPE_NEWS), 0)
    ent_rows = rng.integers(0, PIPE_ENTITIES, int(n_ents.sum()))
    ent_ends = np.cumsum(n_ents)
    with open(raw / "news.tsv", "w") as f:
        for i, (nid, title) in enumerate(zip(ids.tolist(), titles)):
            ents = json.dumps([{"Label": "e", "WikidataId": f"Q{q}"} for q in ent_rows[ent_ends[i] - n_ents[i] : ent_ends[i]]])
            cat = PIPE_CATEGORIES[i % len(PIPE_CATEGORIES)]
            abstract = f"Abstract of article {i}." if i % 10 else ""
            f.write(f"{nid}\t{cat}\t{cat}{i % 5}\t{title}\t{abstract}\thttps://example.com/{nid}\t{ents}\t[]\n")
    vecs = rng.standard_normal((PIPE_ENTITIES, 100))
    with open(raw / "entity_embedding.vec", "w") as f:
        for q, row in enumerate(vecs):
            f.write(f"Q{q}\t" + "\t".join(f"{v:.6f}" for v in row) + "\t\n")
    hist_lens, imp_lens, hist_rev, cand_rev, _, labels = build_workload(rng, num_rows, PIPE_NEWS)
    hist_tok = ids[hist_rev].tolist()
    imp_tok = np.char.add(ids[cand_rev], np.where(labels > 0, "-1", "-0")).tolist()
    h_end, i_end = np.cumsum(hist_lens), np.cumsum(imp_lens)
    with open(raw / "behaviors.tsv", "w") as f:
        for r in range(num_rows):
            history = " ".join(hist_tok[h_end[r] - hist_lens[r] : h_end[r]])
            imps = " ".join(imp_tok[i_end[r] - imp_lens[r] : i_end[r]])
            f.write(f"{r + 1}\tU{r % 9_000}\t11/1{r % 5}/2019 9:05:58 AM\t{history}\t{imps}\n")
    return dict(rows=num_rows, history_tokens=int(hist_lens.sum()), impression_slots=int(imp_lens.sum()))


def _timed_embed(seconds: list):
    """The save-emb CLI's EmbeddingsComponent, timing its encode into
    ``seconds``."""
    from news_recommendation_project_v2_torch.pipeline import EmbeddingsComponent

    class Timed(EmbeddingsComponent):
        def transform(self, context):
            t0 = time.perf_counter()
            out = super().transform(context)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out

    return Timed


def pipeline_ingest_phase(data_dir: Path) -> tuple[list, list]:
    """11a: write both splits' raw TSVs, run nrtorch-ingest on each, then
    time load_dataset and the compile (TransformDataComponent, the native
    compiler). Returns the train split's impression and history strings
    (12f compiles them by both paths)."""
    from news_recommendation_project_v2_torch.cli import ingest as ingest_cli
    from news_recommendation_project_v2_torch.cli.common import build_context
    from news_recommendation_project_v2_torch.pipeline import TransformDataComponent

    for i, (name, rows) in enumerate(PIPE_ROWS.items()):
        t0 = time.perf_counter()
        counts = write_raw_mind(data_dir, name, rows, SEED + 110 + i)
        t1 = time.perf_counter()
        ingest_cli.main([str(data_dir), name])
        t2 = time.perf_counter()
        ctx = build_context(data_dir, NewsDataset[name])
        behaviors = ctx["behaviors"]
        t3 = time.perf_counter()
        ctx = TransformDataComponent().transform(ctx)
        t4 = time.perf_counter()
        part_line(
            "11a", split=name, news=PIPE_NEWS, entities=PIPE_ENTITIES, **counts, compiled_news=len(ctx["compiled"].news_ids),
            write_s=t1 - t0, ingest_s=t2 - t1, load_dataset_s=t3 - t2, compile_s=t4 - t3,
            reduced=f"{PIPE_NEWS} of 65,238 news, {rows} of MIND-small's {156_965 if 'train' in name else 73_152} rows",
        )
        if "train" in name:
            strings = (behaviors["Impressions"].tolist(), behaviors["History"].tolist())
    return strings


def pipeline_save_emb_phase(data_dir: Path, emb_dir: Path) -> None:
    """11b: nrtorch-save-emb of both splits, e5-large at full width in
    bfloat16 at the memory model's batch: news/s end to end and of the
    encode step, the dump's size, the norms."""
    from news_recommendation_project_v2_torch.cli import save_emb as save_emb_cli

    for name in PIPE_ROWS:
        encode_s: list = []
        t0 = time.perf_counter()
        with mock.patch.object(save_emb_cli, "EmbeddingsComponent", _timed_embed(encode_s)):
            ctx = save_emb_cli.main([str(data_dir), name, "--save-dir", str(emb_dir)])
        seconds = time.perf_counter() - t0
        n = len(ctx["compiled"].news_ids)
        norms = [np.abs(np.linalg.norm(ctx[k], axis=1) - 1).max() for k in ("news_embeddings", "query_news_embeddings")]
        size = sum(p.stat().st_size for p in emb_dir.glob(f"*{name}*"))
        part_line(
            "11b", split=name, news=n, cli_s=seconds, news_per_s=n / seconds, encode_s=encode_s[0],
            encode_news_per_s=n / encode_s[0], dump_gb=size / 1e9, norm_err=[float(x) for x in norms],
        )
        if not max(norms) <= 1e-3:
            raise AssertionError(f"11b {name}: norms off 1 by {norms}")


def _timed_tower_trainer(seen: dict):
    """A TowerTrainer that times its epoch (pairs/s) and profiles its
    second step (the busy share)."""

    class Timed(TowerTrainer):
        def _host_batches(self):
            for count, batch in super()._host_batches():
                seen["pairs"] = seen.get("pairs", 0) + count
                yield count, batch

        def _train_step(self, batch):
            seen["steps"] = seen.get("steps", 0) + 1
            if seen["steps"] != 2:
                return super()._train_step(batch)
            out = []
            seen["profile"] = profile_call("tower epoch step", lambda: out.append(super(Timed, self)._train_step(batch)))
            return out[0]

        def train_one_epoch(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = super().train_one_epoch()
            torch.cuda.synchronize()
            seen["epoch_s"] = time.perf_counter() - t0
            return loss

    return Timed


def train_argv(data_dir: Path, emb_dir: Path, work: Path) -> list[str]:
    return [
        str(data_dir), "--emb-dir", str(emb_dir), "--tower", "latent", "--cls-epochs", "1", "--epochs", "1",
        "--batch-size", "512", "--log-dir", str(work / "logs"), "--ckpt-dir", str(work / "models"),
    ]


def pipeline_train_phase(data_dir: Path, emb_dir: Path, work: Path) -> dict:
    """11c: nrtorch-train --tower latent at D = 1,024 on the dumps (the
    launch counts set to 0 just before and read just after), then the same
    command again, which must take every step from the cache with no
    device work."""
    from news_recommendation_project_v2_torch.cli import train as train_cli
    from news_recommendation_project_v2_torch.pipeline import components as components_module

    seen: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(components_module, "TowerTrainer", _timed_tower_trainer(seen)):
        pipe, train_ctx, dev_ctx = train_cli.main(train_argv(data_dir, emb_dir, work))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _snapshot()
    peak = torch.cuda.max_memory_allocated() / 1e9
    part_line(
        "11c", command="nrtorch-train --tower latent", width=DIM, batch=512, seconds=seconds,
        step_s={name: s for name, s, _ in pipe.step_log}, tower_epoch_s=seen["epoch_s"], pairs=seen["pairs"],
        steps=seen["steps"], pairs_per_s=seen["pairs"] / seen["epoch_s"],
        step_busy_share=seen["profile"]["busy_ms"] / seen["profile"]["wall_ms"], peak_gb=peak,
        train=train_ctx["metrics"], dev=dev_ctx["metrics"], launches=counts["launches"],
    )
    for name, n in counts["launches"].items():
        if n == 0:
            raise AssertionError(f"11c: nrtorch-train never launched the {name} kernel")
    for split in (train_ctx, dev_ctx):
        if not all(0.0 <= split["metrics"][k] <= 1.0 for k in METRIC_KEYS):
            raise AssertionError(f"11c: metrics {split['metrics']}")
    first_dev = dev_ctx["metrics"]
    del train_ctx, dev_ctx

    from torch.profiler import ProfilerActivity, profile

    zero_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe, _, dev_again = train_cli.main(train_argv(data_dir, emb_dir, work))
        torch.cuda.synchronize()
    device_events = sum(
        e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
    )
    hits = {name: hit for name, _, hit in pipe.step_log}
    part_line(
        "11c", command="nrtorch-train again, cache on", seconds=time.perf_counter() - t0, cache_hits=hits,
        step_s={name: s for name, s, _ in pipe.step_log}, device_kernels=device_events, launches=kernel_launches(),
    )
    if not (all(hits.values()) and device_events == 0 and not any(kernel_launches().values())):
        raise AssertionError(f"11c rerun: cache hits {hits}, {device_events} device kernels")
    if dev_again["metrics"] != first_dev:
        raise AssertionError("11c rerun: the cached dev metrics differ from the run's")
    return counts


def pipeline_eval_serve_phase(data_dir: Path, emb_dir: Path, work: Path) -> None:
    """11d: nrtorch-eval --ckpt of the best checkpoint against the flat eval
    computed directly from it; nrtorch-serve --ckpt of it answers a POST
    /rank (the CLI in its own process, stopped afterwards)."""
    import socket

    from news_recommendation_project_v2_torch.cli import eval as eval_cli
    from news_recommendation_project_v2_torch.cli.common import build_context
    from news_recommendation_project_v2_torch.config import DataSubset
    from news_recommendation_project_v2_torch.eval.ranker import history_candidate_slots
    from news_recommendation_project_v2_torch.ops.encode import load_embeddings
    from news_recommendation_project_v2_torch.ops.scoring import _auto_flat_chunk
    from news_recommendation_project_v2_torch.pipeline import TransformDataComponent
    from news_recommendation_project_v2_torch.train.checkpoint import load_pytree

    ckpt = work / "models" / "attention" / "Best_model_e5_query_latent"
    t0 = time.perf_counter()
    ctx = eval_cli.main([str(data_dir), "--dataset", "MINDsmall_dev", "--emb-dir", str(emb_dir), "--ckpt", str(ckpt),
                         "--log-dir", str(work / "logs")])
    eval_s = time.perf_counter() - t0
    compiled = TransformDataComponent().transform(
        build_context(data_dir, NewsDataset.MINDsmall_dev, data_subset=DataSubset.WITH_HISTORY)
    )["compiled"]
    emb, query = load_embeddings(emb_dir, "MINDsmall_dev", with_query=True, align_to_news_ids=compiled.news_ids)
    tower = build_tower(TowerConfig(kind="latent"))
    tower.load_state_dict(load_pytree(ckpt))
    tower.to("cuda")
    slots, rows = history_candidate_slots(compiled)
    view = compiled.with_history_view()
    chunk = _auto_flat_chunk(DIM, int(np.minimum(view.hist_lens, HISTORY_BUCKETS[-1]).sum()), torch.device("cuda"))
    plan = FlatEvalPlan(view.hist_rev, view.hist_lens, compiled.imp_rev[slots], rows, chunk_tokens=chunk,
                        max_len=HISTORY_BUCKETS[-1], device="cuda")
    mplan = DeviceMetricsPlan(compiled.imp_lens, compiled.labels_flat, hist_slots=slots, device="cuda")
    direct = plan.metrics(tower, emb, mplan, query_news_emb=query)
    diff = max(abs(ctx["metrics"][k] - direct[k]) for k in METRIC_KEYS)
    part_line("11d", command="nrtorch-eval --ckpt", seconds=eval_s, metrics=ctx["metrics"], direct=direct,
              max_abs_diff=diff, tol=EVAL_CLI_TOL)
    if not diff <= EVAL_CLI_TOL:
        raise AssertionError(f"11d: nrtorch-eval and the direct flat eval differ by {diff}")
    del tower, plan, mplan

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ids = [str(n) for n in np.load(emb_dir / "MINDsmall_dev_ids.npy")[:40]]
    hist, cands = ids[:20], ids[20:40]
    with open(work / "serve.log", "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "news_recommendation_project_v2_torch.cli.serve", str(emb_dir), "MINDsmall_dev",
             "--ckpt", str(ckpt), "--port", str(port)],
            cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT,
        )
        try:
            t0 = time.perf_counter()
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
                        json.loads(resp.read())
                    break
                except OSError:
                    if proc.poll() is not None or time.perf_counter() - t0 > 180:
                        raise AssertionError("11d: nrtorch-serve did not come up: " + (work / "serve.log").read_text()[-2000:])
                    time.sleep(0.5)
            up_s = time.perf_counter() - t0
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/rank", data=json.dumps({"history": hist, "candidates": cands}).encode(),
                method="POST",
            )
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as resp:
                ranked = json.loads(resp.read())["ranked"]
            rank_ms = (time.perf_counter() - t1) * 1e3
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    check_ranked([(c, s) for c, s in ranked], cands)
    part_line("11d", command="nrtorch-serve --ckpt", up_s=up_s, first_rank_ms=rank_ms, candidates=len(cands))


def pipeline_cpu_check_phase(data_dir: Path, emb_dir: Path) -> None:
    """11e: LoadEmbedding -> Classification -> Attention on 512 train and
    256 dev rows of 11a's data and 11b's dumps, at full width, one epoch
    each from the same starting weights, on the card and on the CPU."""
    from news_recommendation_project_v2_torch.cli.common import build_context
    from news_recommendation_project_v2_torch.cli.train import _PerSplitLoad
    from news_recommendation_project_v2_torch.pipeline import (
        AttentionComponent,
        ClassificationComponent,
        Pipeline,
        TransformDataComponent,
    )

    cfg = TrainConfig(num_epochs=1, batch_size=512)
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        attention = AttentionComponent(tower_config=TowerConfig(kind="latent"), cfg=cfg, device=device)
        pipe = Pipeline("check", [
            ("init_transform", TransformDataComponent()),
            ("load_embedding", _PerSplitLoad(emb_dir)),
            ("classification", ClassificationComponent(cfg=cfg, device=device)),
            ("only_attention", attention),
        ], use_cache=False)
        contexts = [build_context(data_dir, NewsDataset[name], num_samples=n) for name, n in CHECK_ROWS.items()]
        train_ctx, dev_ctx = pipe.train(*contexts)
        runs[device] = dict(
            seconds=time.perf_counter() - t0, train=train_ctx["metrics"], dev=dev_ctx["metrics"],
            weights={k: v.detach().cpu() for k, v in attention.tower.state_dict().items()},
        )
    card, cpu = runs["cuda"], runs["cpu"]
    w_err = norm_rel(torch.cat([v.flatten() for v in card["weights"].values()]),
                     torch.cat([v.flatten() for v in cpu["weights"].values()]))
    m_err = max(
        norm_rel(torch.tensor([card[s][k] for k in METRIC_KEYS]), torch.tensor([cpu[s][k] for k in METRIC_KEYS]))
        for s in ("train", "dev")
    )
    part_line("11e", rows=CHECK_ROWS, width=DIM, card_s=card["seconds"], cpu_s=cpu["seconds"], dev=card["dev"],
              metrics_norm_rel=m_err, weights_norm_rel=w_err, tol=PIPE_CPU_TOL)
    if not (m_err <= PIPE_CPU_TOL and w_err <= PIPE_CPU_TOL):
        raise AssertionError(f"11e: card and CPU differ: metrics {m_err}, weights {w_err}")


def pipeline_reproduce_phase(work: Path) -> None:
    """11f: nrtorch-reproduce --synthetic --epochs 1 --with-e2e with the
    full-width e5-large on write_synthetic_mind's default fixture (60 news,
    40 rows a split; reduced), then nrtorch-train-e2e at --dim 1024 on it."""
    from news_recommendation_project_v2_torch.cli import reproduce as reproduce_cli
    from news_recommendation_project_v2_torch.cli import train_e2e as train_e2e_cli

    root = work / "repro"
    t0 = time.perf_counter()
    rows = reproduce_cli.main([str(root), "--synthetic", "--epochs", "1", "--with-e2e", "--out", str(root / "rows.json")])
    repro_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = train_e2e_cli.main([str(root), "--epochs", "1", "--dim", str(DIM), "--log-dir", str(root / "logs"),
                              "--ckpt-dir", str(root / "models")])
    part_line("11f", reproduce_s=repro_s, rows=rows, train_e2e_s=time.perf_counter() - t0, train_e2e=ctx["metrics"],
              reduced="write_synthetic_mind's 60 news and 40 rows a split")
    if [r["config"] for r in rows] != [0, 1, 2] or not all(np.isfinite(r[k]) for r in rows for k in METRIC_KEYS):
        raise AssertionError(f"11f: reproduce rows {rows}")
    if not all(np.isfinite(ctx["metrics"][k]) for k in METRIC_KEYS):
        raise AssertionError(f"11f: train-e2e metrics {ctx['metrics']}")


def pipeline_phase(work_dir: Path) -> dict:
    """Phase 11 (11a-11f) in a temporary directory deleted afterwards, the
    working directory moved there (the train CLI's cache is ./cache); each
    part's wall time printed. Returns 11c's launches and shapes, and 11a's
    train strings."""
    import os
    import tempfile

    seconds = {}

    def timed(part: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[part] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return out

    resolve_device("cuda")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
        work = Path(tmp)
        data_dir, emb_dir = work / "data", work / "emb"
        os.chdir(work)
        try:
            strings = timed("11a", pipeline_ingest_phase, data_dir)
            timed("11b", pipeline_save_emb_phase, data_dir, emb_dir)
            counts = timed("11c", pipeline_train_phase, data_dir, emb_dir, work)
            timed("11d", pipeline_eval_serve_phase, data_dir, emb_dir, work)
            timed("11e", pipeline_cpu_check_phase, data_dir, emb_dir)
            timed("11f", pipeline_reproduce_phase, work)
        finally:
            os.chdir(cwd)
    log(json.dumps({"part": "11 wall seconds", **seconds}))
    return dict(counts, strings=strings)


# ---------------------------------------------------------------------------
# Phase 12: the mesh on two ranks that share the card
# ---------------------------------------------------------------------------

# NCCL refuses two ranks on one GPU, so the two-rank parts run gloo over CUDA
# tensors (gloo stages them through host memory); NCCL runs a world of one.
MESH_RANKS = 2
ALLREDUCE_BYTES = 64 * 2**20
# 12e's rows of build_workload, reduced from 5,000 by the smoke's 1,200 s
# limit: on mesh (1, 2) both ranks run the whole batch on the one card, twice
# one rank's work, and one rank runs it again as the reference. At 1,000 rows
# that is 33.4 + 16.3 s of an 849 s smoke (H100 80GB HBM3, 700.00 W); the
# work is linear in rows, so 5,000 would add about 200 s (PERF.md §6). Cut
# to 250 when phase 14 came (PERF.md §4, reduced); 13b's run_config4 runs
# the same rows. Cut further to 128 for the smoke's time.
MESH_ROWS = 128
MESH_TIMED_STEPS = 3  # 12b's timed steps a route
MESH_EVAL_REPEATS = 2  # 12d's timed runs of the sharded eval
MESH_TRAIN = dict(num_epochs=1, batch_size=256)
# 12b/12c: a data-parallel step against one rank's at the same weights (the
# CPU tests' tolerances); 12d: the sharded eval against phase 6's; 12e:
# whole runs against one rank's.
MESH_LOSS_TOL, MESH_GRAD_TOL, MESH_EVAL_TOL, MESH_RUN_METRIC, MESH_RUN_LOSS = 1e-6, 1e-5, 1e-6, 1e-5, 1e-4


def param_digest(model: torch.nn.Module) -> str:
    import hashlib

    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def allreduce_ms(reduce, reps: int = 5) -> tuple[list, bool]:
    """``reps`` timed ``reduce`` calls of a 64 MB float32 tensor of ones (a
    warm-up first), and whether every element reads the world's sum."""
    x = torch.ones(ALLREDUCE_BYTES // 4, device="cuda")
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    world = torch.distributed.get_world_size()
    return times[1:], bool((x == float(world) ** (reps + 1)).all())


def flat_grad(model: torch.nn.Module) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for p in model.parameters() if p.grad is not None])


def mesh_check_steps(mesh, make_model, make_step, loss_of, batch, table, full, steps: int) -> dict:
    """``steps`` data-parallel steps of one global numpy ``batch`` on the
    mesh; before each, rank 0 computes one rank's loss and gradient of the
    whole batch at the same weights. Returns the largest differences (rank
    0) and the weights' digest after the steps."""
    model = make_model()
    step = make_step(mesh, model)
    opt = make_optimizer(TrainConfig(), model.parameters())
    seen = []
    opt.register_step_pre_hook(lambda o, args, kwargs: seen.append(flat_grad(model).clone()))
    local, whole = on(step.shard(batch), "cuda"), on(batch, "cuda")
    loss_err = grad_err = 0.0
    for _ in range(steps):
        if mesh.rank == 0:
            ref = make_model()
            ref.load_state_dict(model.state_dict())
            want = loss_of(ref, full, whole)
            want.backward()
            want_loss, want_grad = float(want.detach()), flat_grad(ref)
            del ref, want
        got = float(step(opt, table, table, local))
        if mesh.rank == 0:
            loss_err = max(loss_err, abs(got - want_loss))
            grad_err = max(grad_err, norm_rel(seen[-1], want_grad))
    return dict(loss_err=loss_err, grad_err=grad_err, digest=param_digest(model), model=model, opt=opt, step=step)


def mesh_timed_steps(mesh, step, opt, table, batches: list, warm: int) -> dict:
    """``warm`` steps, then one timed step a remaining global batch (the
    loss fetched every step, as 7b): ms a step and pairs/s of the global
    batch."""
    local = [on(step.shard(b), "cuda") for b in batches]
    losses = [float(step(opt, table, table, b)) for b in local[:warm]]
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    losses += [float(step(opt, table, table, b)) for b in local[warm:]]
    dt = (time.perf_counter() - t0) / (len(batches) - warm)
    pairs = len(batches[-1][-1])
    return dict(ms_per_step=dt * 1e3, pairs_per_s=pairs / dt, finite=bool(np.isfinite(losses).all()))


def mesh_table() -> torch.Tensor:
    """12b/12c's N(0, 1) table, made on the card from one seed on every
    rank, as 7b makes its own."""
    return torch.randn((NUM_NEWS, DIM), device="cuda", generator=torch.Generator("cuda").manual_seed(SEED + 12))


def mesh_steps_part(mesh21, mesh12) -> dict:
    """12b: mesh (2, 1), the flat step at 7b's global batch (B = 2,048,
    T = 65,536), margin and InfoNCE: 5 steps checked against one rank, then
    3 warm-up and 3 timed; the padded step at B = 512 on 8c.2's batches:
    5 checked, 3 timed. 12c: mesh (1, 2), the row-sharded table: its shard
    and the sharded gather against the plain gather, and 5 flat margin
    steps checked."""
    from news_recommendation_project_v2_torch.parallel import (
        make_sharded_flat_tower_train_step,
        make_sharded_tower_train_step,
        shard_news_table,
        table_sharding,
    )

    state = latent_state_dict_from_jax(random_latent_params(np.random.default_rng(SEED), TowerConfig()))
    emb = mesh_table()
    margin = TrainConfig().margin
    rng = np.random.default_rng(SEED)
    T, total, batch = flat_inputs(TRAIN_B, rng)
    flats = {"margin": batch, "infonce": with_negatives(batch, rng)}
    out = {}
    table21 = shard_news_table(mesh21, emb)
    for name, b in flats.items():
        infonce = name == "infonce"
        loss_fn = LOSSES[name][0]
        r = mesh_check_steps(
            mesh21, lambda: full_tower(state, "cuda"),
            lambda mesh, m: make_sharded_flat_tower_train_step(mesh, m, margin, infonce),
            lambda m, table, bb: loss_fn(m, table, bb, **LOSSES[name][2]), b, table21, emb, steps=5,
        )
        timed = mesh_timed_steps(mesh21, r["step"], r["opt"], table21, [b] * (3 + MESH_TIMED_STEPS), warm=3)
        out[f"12b flat {name}"] = dict(T=T, live_tokens=total, loss_err=r["loss_err"], grad_err=r["grad_err"],
                                        digest=r["digest"], **timed)
        del r
        torch.cuda.empty_cache()
    prng = np.random.default_rng(SEED + 84)
    padded = [padded_from_flat(flat, n)[1] for _, n, flat in (flat_inputs(PADDED_B, prng) for _ in range(1 + MESH_TIMED_STEPS))]
    r = mesh_check_steps(
        mesh21, lambda: padded_tower("latent", state, "cuda"),
        lambda mesh, m: make_sharded_tower_train_step(mesh, m, margin),
        lambda m, table, bb: padded_margin_loss(m, table, bb, margin), padded[0], table21, emb, steps=5,
    )
    timed = mesh_timed_steps(mesh21, r["step"], r["opt"], table21, padded, warm=1)
    out["12b padded margin"] = dict(B=PADDED_B, loss_err=r["loss_err"], grad_err=r["grad_err"], digest=r["digest"],
                                    **timed)
    del r, table21
    torch.cuda.empty_cache()

    table12 = shard_news_table(mesh12, emb)
    sl = table_sharding(mesh12, NUM_NEWS)
    want = torch.zeros((sl.stop - sl.start, DIM), device="cuda")
    want[: min(sl.stop, NUM_NEWS) - sl.start] = emb[sl.start : min(sl.stop, NUM_NEWS)]
    rows = torch.from_numpy(np.concatenate([batch[0], np.arange(NUM_NEWS, dtype=np.int32)])).cuda().long()
    gather_equal = torch.equal(table12.gather(rows), emb[rows])
    r = mesh_check_steps(
        mesh12, lambda: full_tower(state, "cuda"),
        lambda mesh, m: make_sharded_flat_tower_train_step(mesh, m, margin),
        lambda m, table, bb: flat_margin_loss(m, table, bb, margin), batch, table12, emb, steps=5,
    )
    out["12c"] = dict(rows_per_rank=table12.rows_per_shard, shard_equal=torch.equal(table12.local, want),
                      gather_rows=int(rows.numel()), gather_equal=gather_equal, loss_err=r["loss_err"],
                      grad_err=r["grad_err"], digest=r["digest"])
    del r, table12
    torch.cuda.empty_cache()
    return out


def mesh_eval_part(mesh, emb_path: str) -> dict:
    """12d: ShardedFlatEvalPlan + ShardedMetricsPlan over phase 6's
    workload and table, float32: a first run, then three timed metrics runs;
    this rank's token share."""
    from news_recommendation_project_v2_torch.parallel.flat_eval import ShardedFlatEvalPlan, ShardedMetricsPlan

    hist_lens, imp_lens, hist_rev, cand_rev, cand_row, labels = build_workload(np.random.default_rng(SEED))
    cfg = TowerConfig(kind="latent")
    tower = build_tower(cfg)
    tower.load_state_dict(latent_state_dict_from_jax(random_latent_params(np.random.default_rng(SEED), cfg)))
    tower = tower.to("cuda")
    emb = torch.from_numpy(np.load(emb_path)).cuda()
    fplan = ShardedFlatEvalPlan(mesh, hist_rev, hist_lens, cand_rev, cand_row,
                                chunk_tokens=estimate_flat_chunk(cfg, device="cuda"))
    mplan = ShardedMetricsPlan(fplan, imp_lens, labels, hist_slots=np.arange(len(cand_rev), dtype=np.int64))
    first = fplan.metrics(tower, emb, mplan)
    seconds = []
    for _ in range(MESH_EVAL_REPEATS):
        mesh.barrier()
        t0 = time.perf_counter()
        got = fplan.metrics(tower, emb, mplan)
        seconds.append(time.perf_counter() - t0)
    return dict(metrics=first, repeat_equal=got == first, seconds=seconds,
                impressions_per_s=[FLAT_ROWS / t for t in seconds], token_share=fplan.token_share,
                impressions=mplan.num_impressions)


def mesh_config3_part() -> dict:
    """12e: configs.run_config3 on mesh (1, 2) at full width over MESH_ROWS
    of build_workload's rows, one epoch, with every launch count set to 0
    just before and read just after; the trainer's history kept."""
    seen = {}
    train = TowerTrainer.train

    def recorded(self, *args, **kwargs):
        seen["history"] = train(self, *args, **kwargs)
        seen["digest"] = param_digest(self.tower)
        return seen["history"]

    ct, emb = mesh_config3_data()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(TowerTrainer, "train", recorded):
        metrics = configs_module.run_config3(
            ct, emb, mesh_cfg=MeshConfig(model_size=2), train_cfg=TrainConfig(**MESH_TRAIN)
        )
    torch.cuda.synchronize()
    return dict(
        seconds=time.perf_counter() - t0, metrics=metrics, history=seen["history"], digest=seen["digest"],
        launches=kernel_launches(),
        shapes={k: collections.Counter({(s, torch.float32): n for s, n in v["wrapper"].shapes.items()})
                for k, v in KERNELS.items()},
    )


def mesh_config3_data() -> tuple[CompiledBehaviors, np.ndarray]:
    """12e's rows and a row-normalized table, from seeds."""
    ct = mind_behaviors(np.random.default_rng(SEED + 12), MESH_ROWS)
    emb = np.random.default_rng(SEED + 12).standard_normal((NUM_NEWS, DIM), dtype=np.float32)
    return ct, emb / np.linalg.norm(emb, axis=1, keepdims=True)


def mesh_rank(emb_path: str) -> dict:
    """One rank of phase 12 (two ranks over gloo, CUDA tensors on the one
    card): 12a, 12b, 12c, 12d and 12e's run_config3."""
    from news_recommendation_project_v2_torch.parallel import build_mesh

    resolve_device("cuda")  # TF32 off, as every phase runs
    mesh21 = build_mesh(MeshConfig(data_size=2, model_size=1), backend="gloo")
    mesh12 = build_mesh(MeshConfig(data_size=1, model_size=2), backend="gloo")
    times, exact = allreduce_ms(mesh21.sum)
    out = {"12a": dict(backend=torch.distributed.get_backend(), world=torch.distributed.get_world_size(),
                       rank=mesh21.rank, meshes=[mesh21.shape, mesh12.shape], allreduce_64mb_ms=times, exact=exact)}
    out.update(mesh_steps_part(mesh21, mesh12))
    out["12d"] = mesh_eval_part(mesh21, emb_path)
    torch.cuda.empty_cache()
    out["12e"] = mesh_config3_part()
    return out


def nccl_world_of_one() -> dict:
    """12a's NCCL part: a world of one rank (this process) over NCCL, the
    mesh built on it and a 64 MB all_reduce timed."""
    import tempfile

    from news_recommendation_project_v2_torch.parallel import build_mesh

    with tempfile.TemporaryDirectory() as tmp:
        store = torch.distributed.FileStore(str(Path(tmp) / "store"), 1)
        torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            mesh = build_mesh(MeshConfig(), backend="nccl")
            times, exact = allreduce_ms(torch.distributed.all_reduce)
            return dict(backend=torch.distributed.get_backend(), world=1, mesh=mesh.shape, allreduce_64mb_ms=times,
                        exact=exact)
        finally:
            torch.distributed.destroy_process_group()


def mesh_cli_part(work_dir: Path) -> dict:
    """12e's CLI part: nrtorch-train --encode-inline --dim 1024 on
    write_synthetic_mind's fixture (11f's data) in this process, then the same
    with --mesh 2,1 --dist-backend gloo under torchrun (two processes); the
    dev metrics must agree."""
    import os
    import tempfile

    from news_recommendation_project_v2_torch.cli import train as train_cli
    from news_recommendation_project_v2_torch.data.ingest import store_processed_data
    from news_recommendation_project_v2_torch.data.synthetic import write_synthetic_mind

    with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
        root = Path(tmp)
        for ds in (NewsDataset.MINDsmall_train, NewsDataset.MINDsmall_dev):
            write_synthetic_mind(root, ds)
            store_processed_data(root, ds)
        argv = [str(root), "--encode-inline", "--dim", str(DIM), "--epochs", "1", "--cls-epochs", "1",
                "--batch-size", "32", "--no-cache"]
        t0 = time.perf_counter()
        _, _, dev = train_cli.main(argv + ["--log-dir", str(root / "logs1"), "--ckpt-dir", str(root / "models1")])
        one_s = time.perf_counter() - t0
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(MESH_RANKS),
             "-m", "news_recommendation_project_v2_torch.cli.train", *argv, "--mesh", f"{MESH_RANKS},1",
             "--dist-backend", "gloo", "--log-dir", str(root / "logs2"), "--ckpt-dir", str(root / "models2")],
            cwd=root, env=env, capture_output=True, text=True, timeout=600,
        )
        mesh_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"12e: torchrun nrtorch-train --mesh exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        lines = [line.split(" metrics: ", 1)[1] for line in proc.stdout.splitlines() if line.startswith("dev metrics: ")]
        if len(lines) != 1:
            raise AssertionError(f"12e: want one rank's dev metrics line, got {lines}")
        import ast

        got, want = ast.literal_eval(lines[0]), dev["metrics"]
    gap = max(abs(got[k] - want[k]) for k in METRIC_KEYS)
    return dict(one_rank_s=one_s, torchrun_s=mesh_s, dev=got, gap=gap, same_samples=got["num_samples"] == want["num_samples"])


def mesh_native_part(strings: tuple[list, list]) -> dict:
    """12f: 11a's train rows compiled by the native extension alone
    (compile_native raises where compile_behaviors would fall back to numpy)
    and by numpy; the arrays must be equal."""
    impressions, history = strings
    t0 = time.perf_counter()
    a = compile_native(impressions, history)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = compile_behaviors(impressions, history, use_native=False)
    numpy_s = time.perf_counter() - t0
    fields = ("imp_rev", "imp_row", "imp_lens", "hist_rev", "hist_row", "hist_lens", "hist_row_index", "labels_flat")
    equal = a.news_ids.tolist() == b.news_ids.tolist() and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in fields
    )
    return dict(rows=len(impressions), native_s=native_s, numpy_s=numpy_s, speedup=numpy_s / native_s, equal=equal)


def mesh_phase(work_dir: Path, flat: dict, flat_emb: torch.Tensor, strings: tuple) -> dict:
    """Phase 12 (12a-12f); one JSON line a part. Returns 12e's run_config3
    launches and shapes, summed over the ranks."""
    from news_recommendation_project_v2_torch.parallel import launch

    seconds = {}
    t0 = time.perf_counter()
    part_line("12a", **nccl_world_of_one())
    emb_path = work_dir / "flat_emb.npy"
    np.save(emb_path, flat_emb.cpu().numpy())
    gc.collect()
    torch.cuda.empty_cache()
    ranks = launch(mesh_rank, MESH_RANKS, args=(str(emb_path),), backend="gloo", timeout=900)
    emb_path.unlink()
    seconds["ranks"] = time.perf_counter() - t0
    for r in ranks:
        part_line("12a", **r["12a"])
        if not (r["12a"]["exact"] and r["12a"]["backend"] == "gloo" and r["12a"]["world"] == MESH_RANKS):
            raise AssertionError(f"12a: {r['12a']}")
    first, other = ranks
    for key in ("12b flat margin", "12b flat infonce", "12b padded margin", "12c"):
        got = first[key]
        same = got["digest"] == other[key]["digest"]
        part_line(key, **{k: v for k, v in got.items() if k != "digest"}, ranks_bit_identical=same,
                  rank1=({k: other[key][k] for k in ("ms_per_step", "pairs_per_s")} if "ms_per_step" in got else None))
        if not (same and got["loss_err"] <= MESH_LOSS_TOL and got["grad_err"] <= MESH_GRAD_TOL
                and got.get("finite", True)):
            raise AssertionError(f"{key}: {got}, ranks bit-identical {same}")
    if not (first["12c"]["shard_equal"] and first["12c"]["gather_equal"] and other["12c"]["gather_equal"]):
        raise AssertionError(f"12c: the sharded table {first['12c']} / {other['12c']}")

    want = flat[torch.float32]["metrics"]
    for r in ranks:
        d = r["12d"]
        gap = max(abs(d["metrics"][k] - want[k]) for k in METRIC_KEYS)
        part_line("12d", **{k: v for k, v in d.items() if k != "metrics"}, metrics=d["metrics"],
                  phase6=want, gap=gap)
        if not (gap <= MESH_EVAL_TOL and d["metrics"]["num_samples"] == FLAT_ROWS and d["repeat_equal"]):
            raise AssertionError(f"12d: the sharded eval {d['metrics']} against phase 6's {want}")
    if sum(r["12d"]["impressions"] for r in ranks) != FLAT_ROWS:
        raise AssertionError("12d: the ranks' impressions do not cover the workload")

    t0 = time.perf_counter()
    ct, emb = mesh_config3_data()
    tower_cfg = configs_module._sized_tower(DIM)
    tower = build_tower(tower_cfg)
    cfg = TrainConfig(**MESH_TRAIN)
    tower.load_state_dict(tower_state_dict_from_jax("latent", random_tower_params(np.random.default_rng(cfg.seed), tower_cfg)))
    one = TowerTrainer(tower, ct.with_history_view(), emb, cfg=cfg, flat_train=False, flat_eval=True,
                       device_metrics=True, device="cuda").train()
    one_s = time.perf_counter() - t0
    for r in ranks:
        e = r["12e"]
        got, ref = e["history"][-1], one[-1]
        metric_gap = max(abs(got["train"][k] - ref["train"][k]) for k in METRIC_KEYS)
        loss_gap = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        part_line("12e run_config3", mesh=[1, 2], rows=MESH_ROWS, seconds=e["seconds"], one_rank_seconds=one_s,
                  metrics=e["metrics"], one_rank=ref["train"], metric_gap=metric_gap, loss=got["loss"],
                  loss_gap=loss_gap, launches=e["launches"], reduced=f"{MESH_ROWS} of 5,000 rows")
        if not (metric_gap <= MESH_RUN_METRIC and loss_gap <= MESH_RUN_LOSS and min(e["launches"].values()) > 0):
            raise AssertionError(f"12e: run_config3 on the mesh against one rank: {metric_gap}, {loss_gap}")
    if first["12e"]["digest"] != other["12e"]["digest"]:
        raise AssertionError("12e: the ranks' towers differ after run_config3")
    cli = mesh_cli_part(work_dir)
    part_line("12e nrtorch-train --mesh 2,1", **cli)
    if not (cli["gap"] <= MESH_RUN_METRIC and cli["same_samples"]):
        raise AssertionError(f"12e: the CLI on the mesh against one rank: {cli}")
    native_run = mesh_native_part(strings)
    part_line("12f", **native_run)
    if not native_run["equal"]:
        raise AssertionError("12f: the native and numpy compiles differ")
    seconds["12e one rank, CLI, 12f"] = time.perf_counter() - t0
    log(json.dumps({"part": "12 wall seconds", **seconds}))
    launches = {k: sum(r["12e"]["launches"][k] for r in ranks) for k in KERNELS}
    shapes = {k: sum((r["12e"]["shapes"][k] for r in ranks), collections.Counter()) for k in KERNELS}
    return dict(launches=launches, shapes=shapes)


# ---------------------------------------------------------------------------
# Phase 13: multi-GPU part 2 on two ranks that share the card
# ---------------------------------------------------------------------------

# 13a: data-parallel e2e steps at half of 9c's global batch (MESH2_M,
# MESH2_B), each route checked against one rank for MESH2_CHECK_STEPS steps,
# then MESH2_TIMED_STEPS timed. On mesh (2, 1) the sharded store's gather
# all_reduces both data ranks' [M, T, D] float32 blocks (0.5 GB at this
# batch) through gloo's host copies. The materialize runs over the store's
# first MESH2_MATERIALIZE_NEWS news, the trainer over MESH2_ROWS of 9e's
# rows. Each is reduced for the smoke's time (PERF.md §4 lists the cuts).
MESH2_CHECK_STEPS, MESH2_TIMED_STEPS = 1, 1
MESH2_M, MESH2_B = E2E_M // 2, E2E_B // 2
MESH2_MATERIALIZE_NEWS, MESH2_ROWS = 8_192, 64
MESH2_ROUTES = ("streamed", "resident", "sharded")
# 13a's EndToEndTrainer: 9e's rows at batch 256, not run_config2's 32: at 32
# the epoch's 280 steps would each exchange 33 M gradients through gloo
# (about 0.1 s), 8x the exchanges for the same pairs.
MESH2_TRAIN = dict(num_epochs=1, batch_size=256)
MESH2_ENCODE_NEWS = 8_192  # 13b: of phase 10's titles
MESH2_TP_NEWS = 256  # 13c: one bucket of titles, float32
MESH2_SEQ_B, MESH2_SEQ_L = 512, 512  # 13d
# Tolerances: the CPU tests' (tests/test_torch_mesh_{e2e,encode,serve}.py),
# phase 10's bfloat16 one for the sharded encode (two batch splits of one
# bfloat16 computation).
MESH2_LOSS_TOL, MESH2_GRAD_TOL, MESH2_TOL = 1e-6, 1e-5, 1e-5


def trimmed(ids: np.ndarray, mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Token grids cut to their longest row (the titles' 15-35 tokens of
    the tokenizer's 128): the pads after it change no real token's state."""
    width = int(mask.sum(1).max())
    return ids[:, :width], mask[:, :width]


class LaunchRecord:
    """The kernels' launches and shapes summed over the parts of one rank's
    mesh path: ``counted(fn)`` sets every count to 0, runs ``fn`` and adds
    what it launched (the checks against one rank run outside it)."""

    def __init__(self):
        self.launches = collections.Counter()
        self.shapes = {k: collections.Counter() for k in KERNELS}

    def counted(self, fn):
        torch.cuda.synchronize()
        zero_launches()
        out = fn()
        torch.cuda.synchronize()
        self.launches.update(kernel_launches())
        for k, v in KERNELS.items():
            self.shapes[k].update({(s, torch.float32): n for s, n in v["wrapper"].shapes.items()})
        return out


def mesh2_steps(mesh, route: str, store: TokenStore, batch: dict, rec: LaunchRecord) -> dict:
    """One route of 13a on ``mesh``: MESH2_CHECK_STEPS data-parallel steps of
    the global ``batch`` (half of 9c's), each against one rank's loss and
    gradient at the same weights (rank 0), then MESH2_TIMED_STEPS timed (ms
    a step, pairs/s), the weights' digest, and the bytes a step's store
    gather moves."""
    from news_recommendation_project_v2_torch.parallel import (
        make_sharded_e2e_train_step,
        make_sharded_e2e_train_step_gathered,
        shard_token_store_states,
    )

    state = e2e_state()
    model = e2e_model(state, "cuda", dropout=False)
    margin = TrainConfig().margin
    enc, tower = model["token_encoder"], model["tower"]
    if route == "streamed":
        step, states = make_sharded_e2e_train_step(mesh, enc, tower, margin), None
    else:
        sharded = route == "sharded"
        step = make_sharded_e2e_train_step_gathered(mesh, enc, tower, margin, sharded_store=sharded)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = shard_token_store_states(mesh, store.states) if sharded else _upload_states(store.states, torch.device("cuda"))
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
    opt = make_optimizer(TrainConfig(), model.parameters())
    seen = []
    opt.register_step_pre_hook(lambda o, args, kwargs: seen.append(flat_grad(model).clone()))
    glob = batch["streamed" if route == "streamed" else "gathered"]
    local = on(step.shard(glob), "cuda")
    loss_err = grad_err = 0.0
    for _ in range(MESH2_CHECK_STEPS):
        if mesh.rank == 0:
            ref = e2e_model(state, "cuda", dropout=False)
            ref.load_state_dict(model.state_dict())
            want = e2e_loss(ref, on(batch["streamed"], "cuda"), "margin")
            want.backward()
            want_loss, want_grad = float(want.detach()), flat_grad(ref)
            del ref, want
            torch.cuda.empty_cache()
        got = float(step(opt, states, None, local))
        if mesh.rank == 0:
            loss_err = max(loss_err, abs(got - want_loss))
            grad_err = max(grad_err, norm_rel(seen[-1], want_grad))
    mesh.barrier()
    t0 = time.perf_counter()
    losses = rec.counted(lambda: [float(step(opt, states, None, local)) for _ in range(MESH2_TIMED_STEPS)])
    dt = (time.perf_counter() - t0) / MESH2_TIMED_STEPS
    out = dict(mesh=list(mesh.shape.values()), route=route, M=MESH2_M, T=E2E_T, B=MESH2_B, L=E2E_L,
               local_M=int(local[2].shape[0]), loss_err=loss_err, grad_err=grad_err, ms_per_step=dt * 1e3,
               pairs_per_s=MESH2_B / dt, finite=bool(np.isfinite(losses).all()), digest=param_digest(model))
    if route != "streamed":
        out.update(store_gb_per_rank=states.local.numel() * states.local.element_size() / 1e9 if route == "sharded"
                   else states.numel() * states.element_size() / 1e9, upload_seconds=upload_s)
    if route == "sharded":
        out["gather_bytes_per_step"] = int(local[0].numel()) * DIM * states.local.element_size()
    del model, opt, step, states, local, seen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh2_materialize(mesh, store: TokenStore, want_path: str, rec: LaunchRecord) -> list:
    """13a: materialize_from_token_store_mesh over the store's first
    MESH2_MATERIALIZE_NEWS news at 9d's settings, from the store resident on
    both ranks and from the ShardedStore: news/s and the largest difference
    from phase 9d's resident result for those news."""
    from news_recommendation_project_v2_torch.ops.encode import materialize_from_token_store_mesh
    from news_recommendation_project_v2_torch.parallel import shard_token_store_states

    enc = e2e_model(e2e_state(), "cuda")["token_encoder"]
    n = MESH2_MATERIALIZE_NEWS
    store = TokenStore(states=store.states[: store.offsets[n]], offsets=store.offsets[: n + 1])
    want = np.load(want_path)[:n]
    out = []
    for route in ("resident", "sharded"):
        states = shard_token_store_states(mesh, store.states) if route == "sharded" else _upload_states(
            store.states, torch.device("cuda"))
        mesh.barrier()
        t0 = time.perf_counter()
        got = rec.counted(lambda: materialize_from_token_store_mesh(
            enc, store, mesh, states, batch_size=None, max_token_len=E2E_T))
        seconds = time.perf_counter() - t0
        out.append(dict(mesh=list(mesh.shape.values()), route=route, news=store.num_items, seconds=seconds,
                        news_per_s=store.num_items / seconds, max_diff_9d=float(np.abs(got - want).max()),
                        finite=bool(np.isfinite(got).all())))
        del states, got
        torch.cuda.empty_cache()
    return out


def mesh2_trainer(mesh, store: TokenStore, rec: LaunchRecord) -> dict:
    """13a: EndToEndTrainer(mesh=) on MESH2_ROWS rows drawn as 9e draws its
    rows, at run_config2's modules, weights and settings (batch MESH2_TRAIN's), dropout off, one epoch and
    its fused eval, against the same trainer on one rank (rank 0)."""
    cfg = TrainConfig(**MESH2_TRAIN)
    compiled = mind_behaviors(np.random.default_rng(SEED + 93), MESH2_ROWS).with_history_view()

    def run(m):
        model = e2e_model(e2e_state_dict_from_jax(random_e2e_params(np.random.default_rng(cfg.seed), DIM, 1, E2E_TOWER)),
                          "cuda", dropout=False)
        t = EndToEndTrainer(model["token_encoder"], model["tower"], compiled, store, cfg=cfg, max_token_len=E2E_T,
                            eval_each_epoch=True, flat_eval=True, device_metrics=True, mesh=m, device="cuda")
        t0 = time.perf_counter()
        history = t.train()
        return dict(seconds=time.perf_counter() - t0, history=history, digest=param_digest(t.model),
                    store_sharded=t.store_sharded, device_store=t.device_store)

    got = rec.counted(lambda: run(mesh))
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        got["one_rank"] = run(None)
    mesh.barrier()
    return got


def mesh2_encode(mesh12, mesh21, rec: LaunchRecord) -> dict:
    """13b: make_sharded_encode_fn with e5-large (bfloat16) over
    MESH2_ENCODE_NEWS of phase 10's titles on mesh (2, 1), against one rank
    (rank 0); then run_config4 on mesh (1, 2) over 12e's rows with phase
    10's titles, with train_cfg=None and with MESH_TRAIN, against
    run_config0 / run_config3 on one rank over the same table."""
    from news_recommendation_project_v2_torch.parallel import make_sharded_encode_fn

    enc, tok = build_encoder(encoder_config=EncoderConfig(), max_length=ENC_MAX_LENGTH, seed=SEED, device="cuda")
    texts = news_texts(NUM_NEWS, SEED + 12)
    ids, mask = trimmed(*tok(texts[:MESH2_ENCODE_NEWS]))
    fn = make_sharded_encode_fn(mesh21, enc)
    mesh21.barrier()
    t0 = time.perf_counter()
    got = fn(ids, mask)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = dict(encode=dict(mesh=[2, 1], news=MESH2_ENCODE_NEWS, T=ids.shape[1], dtype=enc.config.compute_dtype,
                           seconds=seconds, news_per_s=MESH2_ENCODE_NEWS / seconds))
    if mesh21.rank == 0:
        with torch.inference_mode():
            t0 = time.perf_counter()
            want = enc(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda())
            torch.cuda.synchronize()
            out["encode"].update(one_rank_seconds=time.perf_counter() - t0, norm_rel=norm_rel(got, want))
        del want
    del got, fn
    torch.cuda.empty_cache()

    # run_config4 over 12e's rows, whose news ids are the rows of phase 10's
    # titles; one rank's table is encoded in run_config4's chunks, so that it
    # is the mesh's to the bit (both ranks of mesh (1, 2) encode every row).
    ct, _ = mesh_config3_data()
    ids, mask = trimmed(*tok([texts[int(r)] for r in ct.news_ids]))
    config4 = {}
    for name, train in (("config0", None), ("config3", TrainConfig(**MESH_TRAIN))):
        mesh12.barrier()
        t0 = time.perf_counter()
        metrics = rec.counted(lambda: configs_module.run_config4(
            ct, ids, mask, enc, mesh_cfg=MeshConfig(data_size=1, model_size=2), train_cfg=train))
        config4[name] = dict(metrics=metrics, seconds=time.perf_counter() - t0)
    if mesh12.rank == 0:
        t0 = time.perf_counter()
        chunk = configs_module._ENCODE_ROWS
        with torch.inference_mode():
            table = np.concatenate([
                enc(torch.from_numpy(ids[a : a + chunk]).cuda(), torch.from_numpy(mask[a : a + chunk]).cuda())
                .float().cpu().numpy() for a in range(0, len(ids), chunk)
            ])
        config4["config0"]["one_rank"] = configs_module.run_config0(ct, table)
        tower_cfg = configs_module._sized_tower(DIM)
        tower = build_tower(tower_cfg)
        cfg = TrainConfig(**MESH_TRAIN)
        tower.load_state_dict(tower_state_dict_from_jax(
            "latent", random_tower_params(np.random.default_rng(cfg.seed), tower_cfg)))
        view = ct.with_history_view()
        history = TowerTrainer(tower, view, table, compiled_val=view, news_emb_val=table, cfg=cfg, flat_train=False,
                               flat_eval=True, device_metrics=True, device="cuda").train()
        config4["config3"]["one_rank"] = history[-1]["val"]
        config4["one_rank_seconds"] = time.perf_counter() - t0
    mesh12.barrier()
    out["config4"] = config4
    del enc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh2_tensor_parallel(mesh12) -> dict:
    """13c: e5-large in float32 under shard_encoder_params_tp on mesh
    (1, 2) over MESH2_TP_NEWS titles, against the whole encoder on one rank
    (each rank computes both): the split leaves, the weights' bytes and the
    peak memory of a forward per rank, and the norm-relative difference."""
    from news_recommendation_project_v2_torch.parallel import shard_encoder_params_tp

    enc, tok = build_encoder(encoder_config=EncoderConfig(), max_length=ENC_MAX_LENGTH, compute_dtype="float32",
                             seed=SEED, device="cuda")
    ids, mask = (torch.from_numpy(a).cuda() for a in trimmed(*tok(news_texts(MESH2_TP_NEWS, SEED + 13))))

    def forward(model):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(ids, mask)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 1e9

    def weight_gb(model):
        return sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9

    want, one_s, one_peak = forward(enc)
    one_gb = weight_gb(enc)
    tp = shard_encoder_params_tp(mesh12, enc)
    del enc
    gc.collect()
    torch.cuda.empty_cache()
    got, tp_s, tp_peak = forward(tp)
    out = dict(mesh=[1, 2], news=MESH2_TP_NEWS, T=int(ids.shape[1]), split_leaves=len(tp.split_leaves),
               split_examples=tp.split_leaves[:6], weights_gb=weight_gb(tp), one_rank_weights_gb=one_gb,
               forward_peak_gb=tp_peak, one_rank_forward_peak_gb=one_peak, seconds=tp_s, one_rank_seconds=one_s,
               norm_rel=norm_rel(got, want))
    del tp, got, want
    torch.cuda.empty_cache()
    return out


def mesh2_sequence(mesh12, rec: LaunchRecord) -> dict:
    """13d: the latent tower at full width over [MESH2_SEQ_B, MESH2_SEQ_L]
    histories (a seeded N(0, 1) block, masks of half density with slot 0
    live) with the sequence split over mesh (1, 2), against the padded
    tower on one rank (each rank computes both)."""
    from news_recommendation_project_v2_torch.parallel import make_sequence_sharded_tower_fn

    tower = full_tower(latent_state_dict_from_jax(random_latent_params(np.random.default_rng(SEED), TowerConfig())),
                       "cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    mask = (torch.rand((MESH2_SEQ_B, MESH2_SEQ_L), device="cuda", generator=gen) < 0.5).float()
    mask[:, 0] = 1.0
    x = torch.randn((MESH2_SEQ_B, MESH2_SEQ_L, DIM), device="cuda", generator=gen) * mask[..., None]
    fn = make_sequence_sharded_tower_fn(mesh12, tower)
    mesh12.barrier()
    t0 = time.perf_counter()
    got = rec.counted(lambda: fn(x, mask))
    seconds = time.perf_counter() - t0
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = tower(x, mask)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
    out = dict(mesh=[1, 2], B=MESH2_SEQ_B, L=MESH2_SEQ_L, D=DIM, seconds=seconds, one_rank_seconds=one_s,
               max_diff=float((got - want).abs().max()))
    del x, got, want
    torch.cuda.empty_cache()
    return out


def mesh2_serve(mesh12, work_dir: Path, requests: list, rec: LaunchRecord) -> dict:
    """13e: build_ranker(mesh=(1, 2)) over phase 4's dump (65,238 x 1,024)
    and checkpoint: rank 0 answers rank, rank_batch of phase 4's requests
    and retrieve(k=10), then three timed rank_batch (requests/s), while
    rank 1 follows; rank 0 then answers the same with phase 4's
    single-device ranker."""
    ranker = build_ranker(work_dir / "emb", "MINDsmall_dev", work_dir / "tower.pt", TowerConfig(kind="latent"),
                          device="cuda", mesh=mesh12)

    def calls(r):
        return dict(rank=[r.rank(*requests[0])], rank_batch=r.rank_batch(requests),
                    retrieve=[r.retrieve(requests[0][0], k=10), r.retrieve(requests[1][0], k=10)])

    if mesh12.rank != 0:
        served = rec.counted(ranker.follow)
        del ranker
        torch.cuda.empty_cache()
        return dict(served=served)
    got = rec.counted(lambda: calls(ranker))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ranker.rank_batch(requests)
        times.append(time.perf_counter() - t0)
    ranker.close()
    del ranker
    torch.cuda.empty_cache()
    want = calls(build_ranker(work_dir / "emb", "MINDsmall_dev", work_dir / "tower.pt", TowerConfig(kind="latent"),
                              device="cuda"))
    ids_equal, diff = True, 0.0
    for call in want:
        for g, w in zip(got[call], want[call]):
            ids_equal &= [c for c, _ in g] == [c for c, _ in w]
            diff = max(diff, max(abs(a - b) for (_, a), (_, b) in zip(g, w)))
    return dict(mesh=[1, 2], news=NUM_NEWS, requests=len(requests), requests_per_s=[len(requests) / t for t in times],
                ids_equal=ids_equal, max_score_diff=diff)


def mesh2_rank(work_dir: str, store_state: torch.Tensor, want_9d: str, requests: list) -> dict:
    """One rank of phase 13 (two ranks over gloo, CUDA tensors on the one
    card): 13a-13e, and the kernels' launches and shapes of its mesh path."""
    from news_recommendation_project_v2_torch.parallel import build_mesh

    resolve_device("cuda")
    mesh21 = build_mesh(MeshConfig(data_size=2, model_size=1), backend="gloo")
    mesh12 = build_mesh(MeshConfig(data_size=1, model_size=2), backend="gloo")
    rec = LaunchRecord()
    seconds, out = {}, {}

    def timed(part: str, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[part] = time.perf_counter() - t0
        return result

    gen = torch.Generator(device="cuda")
    gen.set_state(store_state)
    store = timed("13a store", e2e_store, gen)  # phase 9's store: its rule from 9a's generator state
    batch = e2e_batch(store, np.random.default_rng(SEED + 131), MESH2_M, MESH2_B)
    out["13a steps"] = timed("13a steps", lambda: [mesh2_steps(m, route, store, batch, rec)
                                                  for m in (mesh21, mesh12) for route in MESH2_ROUTES])
    del batch
    out["13a materialize"] = timed("13a materialize", mesh2_materialize, mesh21, store, want_9d, rec)
    out["13a trainer"] = timed("13a trainer", mesh2_trainer, mesh21, store, rec)
    del store
    gc.collect()
    out["13b"] = timed("13b", mesh2_encode, mesh12, mesh21, rec)
    out["13c"] = timed("13c", mesh2_tensor_parallel, mesh12)
    out["13d"] = timed("13d", mesh2_sequence, mesh12, rec)
    out["13e"] = timed("13e", mesh2_serve, mesh12, Path(work_dir), requests, rec)
    out["seconds"] = seconds
    out["launches"], out["shapes"] = dict(rec.launches), rec.shapes
    return out


def mesh2_cli_part(work_dir: Path, requests: list) -> dict:
    """13e's CLI part: nrtorch-serve --mesh 1,2 --dist-backend gloo --stdio
    under torchrun (two processes) over phase 4's dump and checkpoint,
    answering one rank request on stdin, against the single-device ranker
    in this process."""
    import os

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    work_dir = work_dir.resolve()
    hist, cands = requests[0]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(MESH_RANKS),
         "-m", "news_recommendation_project_v2_torch.cli.serve", str(work_dir / "emb"), "MINDsmall_dev",
         "--ckpt", str(work_dir / "tower.pt"), "--stdio", "--mesh", f"1,{MESH_RANKS}", "--dist-backend", "gloo"],
        input=json.dumps({"op": "rank", "history": hist, "candidates": cands}) + "\n",
        cwd=work_dir, env=env, capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"13e: torchrun nrtorch-serve --mesh exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if len(lines) != 1:
        raise AssertionError(f"13e: want rank 0's one answer, got {proc.stdout[-2000:]}")
    got = json.loads(lines[0])["ranked"]
    want = build_ranker(work_dir / "emb", "MINDsmall_dev", work_dir / "tower.pt", TowerConfig(kind="latent"),
                        device="cuda").rank(hist, cands)
    return dict(torchrun_s=seconds, ids_equal=[c for c, _ in got] == [c for c, _ in want],
                max_score_diff=max(abs(a - b) for (_, a), (_, b) in zip(got, want)))


def mesh2_phase(work_dir: Path, e2e: dict, requests: list) -> dict:
    """Phase 13 (13a-13e); one JSON line a part. Returns the launches and
    shapes of the mesh path, summed over the ranks."""
    from news_recommendation_project_v2_torch.parallel import launch

    t0 = time.perf_counter()
    want_path = work_dir / "materialized_9d.npy"
    np.save(want_path, e2e["materialized"])
    gc.collect()
    torch.cuda.empty_cache()
    ranks = launch(mesh2_rank, MESH_RANKS, args=(str(work_dir), e2e["store_state"], str(want_path), requests),
                   backend="gloo", timeout=900)
    want_path.unlink()
    first, other = ranks
    for r in ranks:
        log(json.dumps({"part": "13 rank wall seconds", **r["seconds"]}))
    for got, peer in zip(first["13a steps"], other["13a steps"]):
        same = got["digest"] == peer["digest"]
        part_line("13a steps", **{k: v for k, v in got.items() if k != "digest"}, ranks_bit_identical=same,
                  rank1_ms_per_step=peer["ms_per_step"], loss_tol=MESH2_LOSS_TOL, grad_tol=MESH2_GRAD_TOL)
        if not (same and got["finite"] and got["loss_err"] <= MESH2_LOSS_TOL and got["grad_err"] <= MESH2_GRAD_TOL):
            raise AssertionError(f"13a: {got}, ranks bit-identical {same}")
    for r in ranks:
        for got in r["13a materialize"]:
            part_line("13a materialize", **got, tol=MESH2_TOL)
            if not (got["finite"] and got["max_diff_9d"] <= MESH2_TOL):
                raise AssertionError(f"13a materialize: {got}")
    got, ref = first["13a trainer"], first["13a trainer"]["one_rank"]
    g, w = got["history"][-1], ref["history"][-1]
    metric_gap = max(abs(g["train"][k] - w["train"][k]) for k in METRIC_KEYS)
    loss_gap = abs(g["loss"] - w["loss"]) / abs(w["loss"])
    same = got["digest"] == other["13a trainer"]["digest"]
    part_line("13a EndToEndTrainer(mesh=)", mesh=[2, 1], rows=MESH2_ROWS, **MESH2_TRAIN, seconds=got["seconds"],
              one_rank_seconds=ref["seconds"], device_store=got["device_store"], store_sharded=got["store_sharded"],
              loss=g["loss"], one_rank_loss=w["loss"], metrics=g["train"], one_rank=w["train"],
              metric_gap=metric_gap, loss_gap=loss_gap, ranks_bit_identical=same)
    if not (same and metric_gap <= MESH_RUN_METRIC and loss_gap <= MESH_RUN_LOSS):
        raise AssertionError(f"13a: EndToEndTrainer on the mesh against one rank: {metric_gap}, {loss_gap}, {same}")

    enc = first["13b"]["encode"]
    part_line("13b sharded encode", **enc, tol=ENC_BF16_TOL)
    if not enc["norm_rel"] <= ENC_BF16_TOL:
        raise AssertionError(f"13b: the sharded encode against one rank: {enc}")
    config4 = first["13b"]["config4"]
    for name in ("config0", "config3"):
        gaps = [max(abs(r["13b"]["config4"][name]["metrics"][k] - config4[name]["one_rank"][k]) for k in METRIC_KEYS)
                for r in ranks]
        part_line(f"13b run_config4 {name}", mesh=[1, 2], rows=MESH_ROWS, seconds=config4[name]["seconds"],
                  metrics=config4[name]["metrics"], one_rank=config4[name]["one_rank"], gap=max(gaps),
                  one_rank_seconds=config4["one_rank_seconds"], reduced=f"{MESH_ROWS} of 5,000 rows")
        if not max(gaps) <= MESH_RUN_METRIC:
            raise AssertionError(f"13b: run_config4 {name} against one rank: {gaps}")
    for r in ranks:
        tp = r["13c"]
        part_line("13c tensor parallel", **tp, tol=MESH2_TOL)
        if not (tp["norm_rel"] <= MESH2_TOL and tp["split_leaves"] > 0 and tp["weights_gb"] < tp["one_rank_weights_gb"]):
            raise AssertionError(f"13c: {tp}")
        seq = r["13d"]
        part_line("13d sequence-sharded tower", **seq, tol=MESH2_TOL)
        if not seq["max_diff"] <= MESH2_TOL:
            raise AssertionError(f"13d: {seq}")
    serve = first["13e"]
    part_line("13e Ranker(mesh=)", **serve, followed=other["13e"]["served"], tol=MESH2_TOL)
    if not (serve["ids_equal"] and serve["max_score_diff"] <= MESH2_TOL and other["13e"]["served"] > 0):
        raise AssertionError(f"13e: {serve}, followed {other['13e']}")
    cli = mesh2_cli_part(work_dir, requests)
    part_line("13e nrtorch-serve --mesh 1,2", **cli, tol=MESH2_TOL)
    if not (cli["ids_equal"] and cli["max_score_diff"] <= MESH2_TOL):
        raise AssertionError(f"13e: the CLI on the mesh against one device: {cli}")
    launches = {k: sum(r["launches"].get(k, 0) for r in ranks) for k in KERNELS}
    shapes = {k: sum((r["shapes"][k] for r in ranks), collections.Counter()) for k in KERNELS}
    log(json.dumps({"part": "13 wall seconds", "phase": time.perf_counter() - t0, "launches": launches}))
    if min(launches.values()) == 0:
        raise AssertionError(f"13: a kernel never launched on the mesh path: {launches}")
    return dict(launches=launches, shapes=shapes)

# ---------------------------------------------------------------------------
# Phase 14: mixed precision (bfloat16 and float16 compute) on the train paths
# ---------------------------------------------------------------------------

MIXED = "bfloat16"  # the compute type of 14b-14e
# A Function's output and gradients on the card against the CPU's, in a
# 16-bit type: what is rounded to the type may round one unit apart.
UNIT16 = {torch.bfloat16: 2**-8, torch.float16: 2**-11}
MIXED_FN_ROWS = 64  # the CPU's share of 14a: its 16-bit GEMMs are slow
# 14b's gradient check at a reduced batch, with
# tests/test_torch_mixed_precision.py's criteria and the CPU's own float32
# and bfloat16 gradients as the yardstick (no JAX on the card's machine).
MIXED_CHECK_B = 16
MIXED_CHECK_M = 64  # 14d's check: the news of its batch (the CPU runs the float32 token encoder over them)
MIXED_LOSS_TOL = 1e-3
# The float16 checks' batch. The card's host has no fast float16 GEMM: there
# the CPU's float16 step ran at about 0.13 s a token row (0.85 GFLOP/s; 14b's
# B = 16, T = 1,024 check took 130 s a loss, 14c's B = 64 one 270 s, in PR
# 15's chip run 2), against a fraction of a second in bfloat16.
MIXED_F16_CHECK_B = 4
# 14f: float16 scores on the card against the CPU's float16 ranker.
MIXED_SERVE_TOL = 3e-2


def geglu_backward_gemm_ms(c: int, dtype) -> float:
    """Time (ms, CUDA events, back to back) of ``geglu_backward``'s five
    products alone at C rows, D = 1,024, F = 4,096, operands in ``dtype``
    (the recomputed [h | g], dW_out, du, dx, dW_in): the GEGLU backward's
    part of a step's backward GEMMs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    d, f = DIM, 4 * DIM
    x, w_in, w_out, dy, u, d_hg = (
        torch.randn(shape, device="cuda", generator=gen).to(dtype)
        for shape in ((c, d), (2 * f, d), (d, f), (c, d), (c, f), (c, 2 * f))
    )

    def products():
        return F.linear(x, w_in), dy.T @ u, dy @ w_out, d_hg @ w_in, d_hg.T @ x

    return cuda_ms(products, 3)


def mixed_kernels_part(gen) -> None:
    """14a: both kernels in float16 against their plain versions at phase
    3's shapes and at the train paths' (the flat step's [1, 8, 65,536, 512]
    and C = 65,536; the padded step's [512, 8, 256, 512] and C = 131,072;
    the e2e step's [1,024, 8, 64, 256] at 16 latents), with their times and
    bounds; then each Function in bfloat16 and float16 at 256 rows (the
    attention [1, 8, 256, 512], the GEGLU at D = 1,024): its output and
    every gradient on the card (the kernel forward, the attention's float32
    backward, the GEGLU's backward in the 16-bit type) against the same
    Function on the CPU, within a norm-relative unit of the type."""
    cases = [
        ("latent_attention", (b, 8, l, 64, 512))
        for b, l in ((1, 16), (8, 16), (2, 256), (4, 256), (2, 600), (4, 600), (8, 600))
    ]
    cases += [("geglu", (c, DIM, 4 * DIM)) for c in (37, 4800)] + [("geglu", (37, 1536, 4 * 1536))]
    cases += [("latent_attention", s) for s in ((1, 8, 65536, 64, 512), (512, 8, 256, 64, 512), (1024, 8, 64, 16, 256))]
    cases += [("geglu", (c, DIM, 4 * DIM)) for c in (65536, 131072)]
    t0 = time.perf_counter()
    with torch.no_grad():
        for name, shape in cases:
            measured(name, shape, torch.float16, gen)
    log(f"  14a: {len(cases)} float16 shapes measured in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    gaps, launched = {}, {}
    for dtype in (torch.bfloat16, torch.float16):
        for name, shape in (("latent_attention", (1, 8, MIXED_FN_ROWS, 64, 512)), ("geglu", (MIXED_FN_ROWS, DIM, 4 * DIM))):
            fn, args = KERNELS[name]["wrapper"], KERNELS[name]["inputs"](shape, dtype, gen)
            results = []
            for inputs in (args, tuple(a.cpu() for a in args)):
                leaves = tuple(a.clone().requires_grad_() for a in inputs)
                before = fn.launches
                out = fn(*leaves)
                grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(SEED)).to(out.dtype)
                grads = torch.autograd.grad(out, leaves, grad.to(out.device))
                results.append([out.detach().cpu(), *(g.cpu() for g in grads)])
                launched.setdefault(f"{name} {str(dtype)[6:]}", fn.launches - before)
            key = f"{name} {str(dtype)[6:]}"
            gaps[key] = max(norm_rel(a, b) for a, b in zip(*results))
            if not (gaps[key] <= UNIT16[dtype] and launched[key] == 1 and all(torch.isfinite(a).all() for a in results[0])):
                raise AssertionError(f"14a {key}: card against CPU {gaps[key]} (tol {UNIT16[dtype]}), launches {launched[key]}")
    part_line("14a Functions, card against CPU", rows=MIXED_FN_ROWS, worst_norm_rel=gaps,
              tol={str(k)[6:]: v for k, v in UNIT16.items()}, kernel_launches_under_autograd=launched,
              seconds=time.perf_counter() - t0)


def held_to_cpu(part: str, runs: dict, **fields) -> None:
    """A 16-bit step on the card held to the same step on the CPU, with
    tests/test_torch_mixed_precision.py's criteria and the CPU's float32
    gradients as the yardstick (no JAX on the card's machine). ``runs``
    maps "card", "cpu" (both in the 16-bit type) and "cpu32" to (loss,
    {leaf: float64 gradient}): the card's loss within MIXED_LOSS_TOL of the
    CPU's, and every leaf's gradient g, with the CPU's float32 (g32) and
    16-bit (gc) ones, |g - g32| <= 1.5 |gc - g32| + 5e-3 |g32| and
    |g - gc| <= 0.15 |gc| (norms). One JSON line; raises on a miss."""
    (loss_card, g), (loss_cpu, gc), (_, g32) = runs["card"], runs["cpu"], runs["cpu32"]
    excess = {
        n: ((g[n] - g32[n]).norm() - 5e-3 * g32[n].norm()).item() / max((gc[n] - g32[n]).norm().item(), 1e-30)
        for n in g32
    }
    rel = {n: ((g[n] - gc[n]).norm() / gc[n].norm()).item() for n in g32}
    worst_excess, worst_rel = max(excess, key=excess.get), max(rel, key=rel.get)
    part_line(part, **fields, leaves=len(g32), loss_card=loss_card, loss_cpu=loss_cpu,
              worst_excess_over_cpu_error=excess[worst_excess], worst_excess_leaf=worst_excess,
              worst_norm_rel_to_cpu=rel[worst_rel], worst_norm_rel_leaf=worst_rel,
              tol=dict(loss=MIXED_LOSS_TOL, excess=1.5, norm_rel=0.15))
    if not (abs(loss_card - loss_cpu) <= MIXED_LOSS_TOL and all(v <= 1.5 for v in excess.values())
            and all(v <= 0.15 for v in rel.values()) and set(g) == set(gc) == set(g32)):
        raise AssertionError(f"{part} {fields}: the card's step against the CPU's: loss {loss_card} / {loss_cpu}, "
                             f"excess {excess[worst_excess]} ({worst_excess}), norm-relative {rel[worst_rel]} "
                             f"({worst_rel})")


def grads_by_device(make_model, loss_of, computes) -> dict:
    """One step's loss and float64 gradients ({leaf: tensor} on the host),
    dropout off, for each of ``computes``: {compute: {"card": ..., "cpu":
    ..., "cpu32": ...}}, the step on the card and on the CPU in that type
    and on the CPU in float32 (taken once)."""

    def run(dev: str, compute: str) -> tuple:
        model = make_model(dev, compute)
        loss = loss_of(model, dev)
        loss.backward()
        return loss.item(), {n: p.grad.detach().cpu().double() for n, p in model.named_parameters() if p.grad is not None}

    cpu32 = run("cpu", "float32")
    return {c: {"card": run("cuda", c), "cpu": run("cpu", c), "cpu32": cpu32} for c in computes}


def trimmed_tokens(batch: tuple, total: int, multiple: int = 64) -> tuple[int, tuple]:
    """A flat batch's token arrays cut to its ``total`` live tokens rounded
    up to ``multiple`` (the pad tokens past them belong to the pad row, which
    the pool drops): the same step over fewer token rows."""
    T = -(-total // multiple) * multiple
    return T, (batch[0][:T], batch[1][:T]) + batch[2:]


def mixed_grad_check(state: dict, emb: torch.Tensor) -> None:
    """14b's check: one flat step at full width, margin and InfoNCE, held to
    the CPU (``held_to_cpu``): in bfloat16 at B = 16 (T = 1,024), in
    float16 at MIXED_F16_CHECK_B with the tokens trimmed to the live ones
    (``trimmed_tokens``)."""
    tables = {"cuda": emb, "cpu": emb.cpu()}
    for compute, B, seed in ((MIXED, MIXED_CHECK_B, SEED + 14), ("float16", MIXED_F16_CHECK_B, SEED + 15)):
        rng = np.random.default_rng(seed)
        T, total, batch = flat_inputs(B, rng)
        if compute == "float16":
            T, batch = trimmed_tokens(batch, total)
        for name, b in (("margin", batch), ("infonce", with_negatives(batch, rng))):
            loss_fn, _, kw = LOSSES[name]
            runs = grads_by_device(lambda dev, dt: full_tower(state, dev, dt),
                                   lambda tower, dev: loss_fn(tower, tables[dev], on(b, dev), **kw), (compute,))
            held_to_cpu("14b gradients", runs[compute], loss=name, B=B, T=T, live_tokens=total, compute=compute)


def mixed_padded_grad_check(state: dict, emb: torch.Tensor) -> None:
    """14c's check: 8c.2's padded margin step of the latent tower (the tower
    that runs the kernels), histories end-aligned into 32 clicks, dropout
    off, held to the CPU (``held_to_cpu``): in bfloat16 at 8c.1's batch (B =
    64), in float16 at MIXED_F16_CHECK_B."""
    tables = {"cuda": emb, "cpu": emb.cpu()}
    margin = TrainConfig().margin
    for compute, B in ((MIXED, CHECK_B), ("float16", MIXED_F16_CHECK_B)):
        rng = np.random.default_rng(SEED + 83)
        _, total, flat = flat_inputs(B, rng)
        L, batch = padded_from_flat(flat, total, CHECK_L)
        runs = grads_by_device(lambda dev, dt: padded_tower("latent", state, dev, dt, dropout_rate=0.0),
                               lambda tower, dev: padded_margin_loss(tower, tables[dev], on(batch, dev), margin),
                               (compute,))
        held_to_cpu("14c gradients", runs[compute], tower="latent", B=B, L=L, live_tokens=total, compute=compute)


def mixed_e2e_grad_check(store: TokenStore, dev_states: torch.Tensor, state: dict) -> None:
    """14d's check, in phase 9 while the store is resident: 9c's resident
    e2e step (the gather from the store on the card, ``TokenAttentionPool``
    float32, the tower in bfloat16) at a reduced batch (M = 64 news, B = 16
    histories of L = 64), dropout off, margin and InfoNCE, held to the
    CPU (``held_to_cpu``; the CPU gathers from the host's copy of the
    store)."""
    rng = np.random.default_rng(SEED + 93)
    flat = {"cuda": dev_states, "cpu": torch.from_numpy(store.states)}
    for loss, negatives in (("margin", 0), ("infonce", TRAIN_K)):
        b = e2e_batch(store, rng, MIXED_CHECK_M, MIXED_CHECK_B, negatives, streamed=False)["gathered"]
        runs = grads_by_device(lambda dev, dt: e2e_model(state, dev, dropout=False, compute=dt),
                               lambda model, dev: e2e_loss(model, on(b, dev), loss, flat[dev]), (MIXED,))
        held_to_cpu("14d gradients", runs[MIXED], loss=loss, route="resident", M=MIXED_CHECK_M, T=E2E_T,
                    B=MIXED_CHECK_B, L=E2E_L, compute=MIXED)


def mixed_flat_part(card: str, f32: dict) -> dict:
    """14b: 7b (``train_step_phase``) in bfloat16: its figures beside 7b's
    float32 ones of this run, the peak memory against the memory model
    (``flat_token_bytes`` x T x ``TRAIN_MULTIPLIER``) and the GEGLU
    backward's products timed alone in both types; then the gradient
    check."""
    state = latent_state_dict_from_jax(random_latent_params(np.random.default_rng(SEED), TowerConfig()))
    emb = torch.randn((NUM_NEWS, DIM), device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    rec = train_step_phase(state, emb, card, MIXED, "14b")
    T = rec["T"]
    model_gb = flat_token_bytes(TowerConfig(compute_dtype=MIXED)) * T * TRAIN_MULTIPLIER / 1e9
    gemms = {str(dt)[6:]: geglu_backward_gemm_ms(T, dt) for dt in (torch.float32, torch.bfloat16)}
    for name, fig in rec["figures"].items():
        ref = f32[name]
        part_line(
            "14b", loss=name, B=TRAIN_B, T=T, live_tokens=rec["live_tokens"], compute=MIXED, **fig,
            float32_ms_per_step=ref["ms_per_step"], float32_pairs_per_s=ref["pairs_per_s"],
            speedup=ref["ms_per_step"] / fig["ms_per_step"], float32_peak_gb=ref["peak_gb"], memory_model_gb=model_gb,
            float32_device_ms_by_part=ref["device_ms_by_part"], geglu_backward_products_ms=gemms,
            geglu_backward_share=gemms["bfloat16"] / fig["device_ms_by_part"]["total"],
            float32_geglu_backward_share=gemms["float32"] / ref["device_ms_by_part"]["total"], card=card,
        )
    mixed_grad_check(state, emb)
    return rec


def mixed_padded_part(states: dict, f32: dict) -> dict:
    """14c: 8c.2 (``padded_step_phase``) for every tower in bfloat16 and the
    latent tower in float16, each beside 8c.2's float32 figures of this
    run; then the latent step's gradient check in both types. Returns the
    latent tower's runs by compute type."""
    emb = torch.randn((NUM_NEWS, DIM), device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 8))
    out = padded_step_phase(states, emb, [(k, MIXED) for k in PADDED_KINDS] + [("latent", "float16")], "14c")
    for (kind, compute), fig in out.items():
        ref = f32[(kind, "float32")]
        part_line("14c against float32", tower=kind, compute=compute, ms_per_step=fig["ms_per_step"],
                  float32_ms_per_step=ref["ms_per_step"], speedup=ref["ms_per_step"] / fig["ms_per_step"],
                  pairs_per_s=fig["pairs_per_s"], float32_pairs_per_s=ref["pairs_per_s"], peak_gb=fig["peak_gb"],
                  float32_peak_gb=ref["peak_gb"], memory_model_gb=fig["memory_model_gb"],
                  float32_device_ms_by_part=ref["device_ms_by_part"])
    mixed_padded_grad_check(states["latent"], emb)
    return {compute: out[("latent", compute)] for compute in (MIXED, "float16")}


def mixed_e2e_part(store: TokenStore, dev_states: torch.Tensor, state: dict, card: str, f32: dict) -> dict:
    """14d (run in phase 9, while the store is resident): 9c
    (``e2e_steps_phase``) on the resident store with the tower in bfloat16
    (``TokenAttentionPool`` float32, as in the JAX package), beside 9c's
    float32 resident figures; then the step's gradient check."""
    rec = e2e_steps_phase(store, dev_states, state, card, MIXED, ("resident",), "14d")
    for (loss, route), fig in rec["figures"].items():
        ref = f32[(loss, route)]
        part_line("14d against float32", loss=loss, route=route, compute=MIXED, ms_per_step=fig["ms_per_step"],
                  float32_ms_per_step=ref["ms_per_step"], speedup=ref["ms_per_step"] / fig["ms_per_step"],
                  pairs_per_s=fig["pairs_per_s"], float32_pairs_per_s=ref["pairs_per_s"], peak_gb=fig["peak_gb"],
                  float32_peak_gb=ref["peak_gb"], float32_device_ms_by_part=ref["device_ms_by_part"])
    mixed_e2e_grad_check(store, dev_states, state)
    return rec


def mixed_trainer_part(f32: list) -> dict:
    """14e: TowerTrainer at full width on 7c's learnable fixture (20,000
    train and 5,000 val rows, batch 2,048, margin, device metrics) with the
    tower in bfloat16, 2 epochs: pairs/s and the val AUC beside 7c's float32
    epochs of this run; the loss falls and the parameters stay float32."""
    ct, cv, emb_t, emb_v = learnable_split(25_000, 20_000, DIM, seed=7)
    figures, trainer, shapes = full_width_epochs("learnable fixture", ct, cv, emb_t, emb_v, 2, MIXED, "14e")
    params32 = all(p.dtype == torch.float32 for p in trainer.tower.parameters())
    falls = figures[-1]["loss"] < figures[0]["loss"]
    part_line("14e", compute=MIXED, epochs=figures, float32_epochs=f32, parameters_float32=params32, loss_falls=falls)
    if not (params32 and falls):
        raise AssertionError(f"14e: parameters float32 {params32}, losses {[f['loss'] for f in figures]}")
    launches = {k: sum(c.values()) for k, c in shapes.items()}
    return dict(launches=launches, shapes=shapes)


def order_agrees(got: list, want: list, slack: float) -> bool:
    """The card's ranking holds the CPU's candidates in the CPU's order
    but where two CPU scores lie within ``slack`` of each other."""
    score = dict(want)
    ids = [c for c, _ in got]
    return sorted(ids) == sorted(score) and all(
        score[b] <= score[a] + slack for i, a in enumerate(ids) for b in ids[i + 1:]
    )


def mixed_serve_part(work_dir: Path, requests: list) -> dict:
    """14f: ``build_ranker`` over phase 4's dump and tower with the latent
    tower in float16, a ``rank_batch`` of phase 4's 64 requests (launch
    counts set to 0 just before it and read just after) and requests/s of
    three more; the first 4 against the same ranker on the CPU: the same
    candidates in the CPU's order (but between candidates whose CPU scores
    lie within twice the largest card-CPU score difference of each other)
    and scores within a norm-relative 3e-2."""
    cfg = TowerConfig(kind="latent", compute_dtype="float16")
    ranker = build_ranker(work_dir / "emb", "MINDsmall_dev", work_dir / "tower.pt", cfg, device="cuda")
    zero_launches()
    got = ranker.rank_batch(requests)
    torch.cuda.synchronize()
    launches, shapes = kernel_launches(), typed_shapes(torch.float16)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ranker.rank_batch(requests)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    want = build_ranker(work_dir / "emb", "MINDsmall_dev", work_dir / "tower.pt", cfg, device="cpu").rank_batch(requests[:4])
    rels, exact, agree = [], 0, 0
    for (_, cands), g, w in zip(requests, got, want):
        check_ranked(g, cands)
        a, b = dict(g), dict(w)
        diff = np.array([a[c] - b[c] for c in cands])
        ref = np.array([b[c] for c in cands])
        rels.append(float(np.linalg.norm(diff) / np.linalg.norm(ref)))
        exact += [c for c, _ in g] == [c for c, _ in w]
        agree += order_agrees(g, w, 2 * float(np.abs(diff).max()))
    part_line("14f", compute="float16", requests=len(requests), requests_per_s=[N_REQUESTS / t for t in times],
              launches=launches, score_norm_rel=rels, tol=MIXED_SERVE_TOL, ids_in_cpu_order=exact,
              ids_in_cpu_order_up_to_ties=agree, compared=len(want))
    if not (max(rels) <= MIXED_SERVE_TOL and agree == len(want) and min(launches.values()) > 0):
        raise AssertionError(f"14f: float16 serving against the CPU: {rels}, {agree} of {len(want)}, {launches}")
    return dict(launches=launches, shapes=shapes)


def mixed_phase(gen, card: str, work_dir: Path, requests: list, train: dict, padded: dict, e2e_mixed: tuple) -> dict:
    """Phase 14 (14a-14f; 14d ran in phase 9); one JSON line a part. Returns
    the launches and shapes of the bfloat16 paths (14b-14e) and of the
    float16 ones (14c's latent step, 14f)."""
    mixed_e2e, e2e_seconds = e2e_mixed
    seconds = {"14d": e2e_seconds}

    def timed(part: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[part] = time.perf_counter() - t0
        return out

    resolve_device("cuda")
    timed("14a", mixed_kernels_part, gen)
    torch.cuda.empty_cache()
    flat = timed("14b", mixed_flat_part, card, train["figures"])
    torch.cuda.empty_cache()
    steps = timed("14c", mixed_padded_part, padded["states"], padded["steps"])
    torch.cuda.empty_cache()
    epochs = timed("14e", mixed_trainer_part, train["learnable"])
    torch.cuda.empty_cache()
    served = timed("14f", mixed_serve_part, work_dir, requests)
    log(json.dumps({"part": "14 wall seconds", **seconds, "phase": sum(seconds.values())}))
    paths = {}
    for dtype, parts in (("bfloat16", (flat, steps["bfloat16"], mixed_e2e, epochs)), ("float16", (steps["float16"], served))):
        launches = {k: sum(p["launches"][k] for p in parts) for k in KERNELS}
        shapes = {}
        for p in parts:
            shapes = add_shapes(shapes, p["shapes"])
        if min(launches.values()) == 0:
            raise AssertionError(f"14: a kernel never launched on the {dtype} paths: {launches}")
        paths[dtype] = dict(launches=launches, shapes=shapes)
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    log(card)

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"phase 2 build: {time.perf_counter() - t0:.2f}s for {sorted(logs)} (nvcc -Xptxas -v):")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    log("phase 3 kernels vs plain versions on the card, at serving shapes: " + since(t_start))
    kernel_phase(gen)

    log("phase 4 serve: full-width latent tower behind build_ranker (TF32 off) " + since(t_start))
    work_dir = ROOT / "build" / "smoke"
    work_dir.mkdir(parents=True, exist_ok=True)
    serve = serve_phase("cuda", work_dir, NUM_NEWS, TowerConfig(kind="latent"))
    log(
        f"  rank_batch of {N_REQUESTS} requests: requests/s {['%.1f' % r for r in serve['rps']]} "
        f"on {card}"
    )
    log(f"  4 requests vs the CPU ranker: max |score difference| {serve['cpu_diff']:.3g} (tol 1e-4)")
    if not serve["cpu_diff"] <= 1e-4:
        raise AssertionError(f"GPU and CPU rankers disagree by {serve['cpu_diff']}")

    log("phase 5 kernels vs plain versions at every shape the main path launched them at: " + since(t_start))
    served = {
        name: collections.Counter({(s, torch.float32): n for s, n in counts.items()})
        for name, counts in serve["shapes"].items()
    }
    records = {"serve": (main_path_phase(served, gen), serve["launches"])}

    log(
        "phase 6 flat eval: FlatEvalPlan + DeviceMetricsPlan at full width, MIND-small scale (TF32 off) "
        + since(t_start)
    )
    runs, flat_emb = flat_eval_phase(gen)
    torch.cuda.empty_cache()
    log("  the kernels vs their plain versions at every shape the flat eval launched them at:")
    flat = {name: sum((r["shapes"][name] for r in runs.values()), collections.Counter()) for name in KERNELS}
    launches = {name: sum(r["launches"][name] for r in runs.values()) for name in KERNELS}
    records["flat_eval"] = (main_path_phase(flat, gen, path="flat eval"), launches)

    log("phase 7 training: the flat-token step and TowerTrainer at full width, float32 (TF32 off) " + since(t_start))
    train = train_phase(gen, card)
    torch.cuda.empty_cache()
    log("  the kernels vs their plain versions at every shape the timed train steps launched them at:")
    records["train"] = (main_path_phase(train["shapes"], gen, path="train"), train["launches"])

    log(
        "phase 8 the padded path and the other towers at full width, float32 (TF32 off) unless bfloat16 "
        "is named " + since(t_start)
    )
    padded = padded_phase(gen, work_dir, serve["requests"])
    torch.cuda.empty_cache()
    log("  the kernels vs their plain versions at every shape the padded eval and train steps launched them at:")
    records["padded_eval"] = (
        main_path_phase(padded["eval"]["shapes"], gen, path="padded eval"), padded["eval"]["launches"]
    )
    records["padded_train"] = (
        main_path_phase(padded["train"]["shapes"], gen, path="padded train"), padded["train"]["launches"]
    )

    log(
        "phase 9 the end-to-end token-level path (config[2]) at full width, float32 (TF32 off) " + since(t_start)
    )
    e2e = e2e_phase(gen, card)
    e2e_mixed = (e2e.pop("mixed"), e2e.pop("mixed_seconds"))
    torch.cuda.empty_cache()
    log("  the kernels vs their plain versions at every shape the e2e steps and run_config2's eval launched them at:")
    records["e2e_train"] = (main_path_phase(e2e["train"]["shapes"], gen, path="e2e train"), e2e["train"]["launches"])
    records["e2e_eval"] = (main_path_phase(e2e["eval"]["shapes"], gen, path="e2e eval"), e2e["eval"]["launches"])

    log("phase 10 the news encoder (e5-large, NV-Embed) and corpus encoding at full width " + since(t_start))
    encoded = encoder_phase(work_dir)
    torch.cuda.empty_cache()
    log("  the kernels vs their plain versions at every shape NV-Embed's head launched them at:")
    records["encoder"] = (main_path_phase(encoded["shapes"], gen, path="encoder"), encoded["launches"])

    log("phase 11 the pipeline and the CLIs from MIND's raw TSVs at full width " + since(t_start))
    piped = pipeline_phase(work_dir)
    torch.cuda.empty_cache()
    log("  the kernels vs their plain versions at every shape nrtorch-train launched them at:")
    records["pipeline"] = (main_path_phase(piped["shapes"], gen, path="pipeline"), piped["launches"])

    # Phase 14 runs before the mesh phases: the later in the run, the more
    # of a short window's kernels the profiler drops (the step splits), most
    # after the mesh phases' process groups.
    log("phase 14 mixed precision: bfloat16 and float16 compute on the train paths and serving " + since(t_start))
    mixed = mixed_phase(gen, card, work_dir, serve["requests"], train, padded, e2e_mixed)
    torch.cuda.empty_cache()
    for dtype, rec in mixed.items():
        log(f"  the kernels vs their plain versions at every shape the {dtype} paths launched them at:")
        records[f"train_{dtype}"] = (main_path_phase(rec["shapes"], gen, path=f"{dtype} paths"), rec["launches"])

    log("phase 12 the mesh: two ranks on the card over gloo, NCCL's world of one, full width " + since(t_start))
    meshed = mesh_phase(work_dir, runs, flat_emb, piped["strings"])
    torch.cuda.empty_cache()
    log("  the kernels vs their plain versions at every shape run_config3 launched them at on the mesh:")
    records["mesh"] = (main_path_phase(meshed["shapes"], gen, path="mesh"), meshed["launches"])

    log("phase 13 multi-GPU part 2: two ranks on the card over gloo, full width " + since(t_start))
    meshed2 = mesh2_phase(work_dir, e2e, serve["requests"])
    del e2e
    torch.cuda.empty_cache()
    log("  the kernels vs their plain versions at every shape the phase 13 mesh path launched them at:")
    records["mesh2"] = (main_path_phase(meshed2["shapes"], gen, path="mesh2"), meshed2["launches"])


    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": meta["source"],
            "replaces": meta["replaces"],
            "path": path,
            "shape": record[name]["label"],
            "launches": counts[name],
            "max_abs_err": record[name]["err"],
            "ms": record[name]["ms"],
            "plain_ms": record[name]["plain_ms"],
            "bound_ms": record[name]["bound_ms"],
            "bound_by": record[name]["bound_by"],
            "library_ms": record[name]["library_ms"],
            "device_ms": record[name]["device_ms"],
            "plain_device_ms": record[name]["plain_device_ms"],
            "library_device_ms": record[name]["library_device_ms"],
        }
        for path, (record, counts) in records.items()
        for name, meta in KERNELS.items()
    ]
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
