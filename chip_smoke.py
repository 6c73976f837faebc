#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``torch_cgx_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, in
order, none of whose failures is caught:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build: ``nvcc`` compiles ``torch_cgx_tpu_torch/csrc/codec.cu`` into
   ``torch_cgx_tpu_torch/_build/``; the registers and shared memory of the
   pipelined kernels; every f32 instance's registers, spills and static
   shared memory against ``csrc/ptxas_f32.json`` (the source before the
   16-bit instances existed; differences logged, a card test holds them),
   the 16-bit instances' beside them. Then the int8 fold's library
   (``codec_cuda.build_int8``) builds on a thread beside phases 3-5, its
   compilers niced;
3. kernels against their plain PyTorch versions on the card, at the shapes
   the GPT-2 124M train step gives them, the pipelined ones (B7a-c) also
   against the single-stage ones, at 1, 131, 133 and 2053 chunks too, and
   at phase 7's flat-SRA epilogue (the multi-row reduce at the
   two-level and the all-to-all shapes of phase 7, the matmul-quantize at
   the three dense-layer shapes of phase 7's flat SRA step and at edge
   geometries where its tiles and the 32-bucket chunks end at different
   places, on float32 operands on the tensor cores as split TF32 (the
   split pass bit for bit against its plain version too) and on its FFMA
   kernel, forced: :func:`check_mm32`): words, meta and decoded values
   must be bit-identical (tolerance 0), the matmul-quantize's own raw row
   too, and the matmul-quantize on normal operands, whose sums the kernels
   and cuBLAS associate differently, within ``payload_close``'s tolerance
   (meta within 1e-5 relative, every decoded value within one level step;
   the raw row within 1e-5 of the row's largest magnitude; the meta error
   of each route printed). Then B9's
   variant kernel (``nometa``, ``metalane``, ``read``; B1's cluster body) at
   bits 1, 2, 4 and 8 on the 64 MB slice and at 1, 131, 133, 2053 and 144
   chunks, and at each cluster geometry of the bucket forced on normal and
   adversarial data, and every
   quantizing kernel (B1, B7a, B3, B7c, B8) in each (encode, pack) lowering:
   bit-identical to the plain version of its encode, the butterfly pack's
   bytes equal to the sum pack's, and on ``qbench.tie_operand`` the mul
   encode's levels different from the div encode's by one level at most.
   Then the cluster kernels (B1/B5, B3, and the pipelined B7a, B7c on
   the same body) against their plain versions on the card's tensors, bit
   for bit: at each launch shape of the step (``tools/shapebench.py``'s) in
   every lowering, B7a and B7c also at every cluster size the bucket takes
   and at tiles of one and two chunks; at bits 1-8 and buckets
   128-16384 on normal and ``qbench.adversarial_operand`` data (B3 at ws 1
   and 4, with and without the raw row), and the div encode's reciprocal
   quotient against the IEEE divide over every divisor significand
   (``codec_cuda.reciprocal_sweep``): no level differs. Last the multi-row
   reduce (B4) at full and at scalar width, bit for bit: at each launch
   shape of phase 7's four-rank steps (``shapebench.REDUCE_SHAPES``), at
   rows 1-8 and 11 with the raw own row in every position and none, and
   with a raw row view that is not 16-byte aligned (the scalar width).
   Then stochastic rounding (:func:`check_stochastic`): B1, B7a, B3 and
   B7c with a seed against their plain versions bit for bit on the 64 MB
   slice and at ws 1, 4 and 8 (raw row or not) in every lowering, B7a's
   bytes equal to B1's and B7c's to B3's, the fused epilogue's to the
   staged one's, at the step's launch shapes, at bits 1-8 and buckets
   128-16384, at every cluster size, tile of one or two chunks and ring
   depth 1-8; every level floor(q) or floor(q) + 1 and the decode's mean
   over 64 seeds unbiased within 4 sigma. Then the 16-bit wire dtypes
   (:func:`check_subf32`): B1/B5, B7a, B3, B7c and B4 on bf16 operands
   at the bf16-parameter step's shapes (f16, the same instances, in the
   card tests), bit for bit, both roundings, every lowering, and the
   decode glue. Last B8 on 16-bit operands (:func:`check_mm16`), bf16 and
   f16 at the three dense-layer shapes, where its tensor-core kernel runs:
   bit for bit against the plain version on integer operands, within the
   f32 check's tolerance on normal ones; its FFMA kernel forced there, bit
   for bit against the plain version and against the upcast route (the
   f32 instance on the operands cast to f32; the raw row that route's sums
   rounded to the operand dtype, then divided); the edge shapes on the
   route their shape takes (tensor cores where TMA can describe them,
   FFMA for din 13 and 100 and a misaligned view), asserted by
   ``MM_TC_LAUNCHES``;
4. the GPT-2 124M slice: three compressed train steps through
   ``make_train_step`` (4 bits, bucket 512, ``CGX_DEBUG_FORCE_CODEC=1``) with
   the launch counters reset just before and read just after, held against
   the counts derived from the gradient layout; one step's gradients synced
   through the kernels and, on the CPU, through the plain versions must agree
   bit for bit. All under ``CGX_PALLAS_DB=off``; then the pipelined path
   (:func:`db_phase`): the same steps from the seed under ``on``, held
   against the layout and bit for bit against ``off``; an autotune sweep of
   the step's shapes into a temporary cache directory (the kernels alone,
   as bursts: the single-stage ones once, the pipelined ones at each tile
   under the shape's cap); one step under ``auto`` over it, which must hit the cache and launch the pipelined
   kernels exactly where the winners say. Then (d) the same steps from the
   seed under ``CGX_PALLAS_PACK=butterfly``, launches held against the
   layout and parameters bit-identical to the sum pack's, and (e) one step
   under ``CGX_CODEC_ENCODE=mul`` with its gradient sync through the kernels
   bit-identical to the plain versions' on the CPU, under mul too, and (f)
   under ``CGX_STOCHASTIC_ROUNDING=1`` a step built with
   ``make_train_step(stochastic_seed=SR_SEED)``: its first step's sync
   through the kernels bit-identical to the plain versions' on the CPU
   with the same key, its launches against the layout; (g) the slice with
   its parameters cast to bf16 (:func:`bf16_phase`): its bf16 gradient
   sync through the kernels bit-identical to the plain versions' on the
   CPU, every B1/B3 launch reading bf16, then the same steps under
   ``CGX_PALLAS_DB`` off and on, launches held against the bf16 layout,
   losses and parameters bit-identical between the two;
5. times: each kernel and its plain version (CUDA events around one call,
   median after warm-up; each kernel also as a burst of back-to-back calls
   queued behind a sleep kernel, ``burst_ms``, which leaves out the host's
   time between launches), each pipelined kernel beside its
   single-stage sibling, the
   matmul-quantize on float32 operands (:func:`time_mm32`) as bursts in
   turns with its FFMA kernel, its split pass alone and float32
   ``torch.matmul`` of the same product (which lacks the quantize), per
   call also against the unfused route for the same payload (that
   product, the divide and the stage-1 quantize: what
   ``CGX_PRODUCER_FUSE=auto`` is decided by), a device-to-device copy as
   the yardstick, the train step without the codec and with it under
   ``CGX_PALLAS_DB`` off and on,
   and a ``torch.profiler`` breakdown of one step of each; B5 and B6 are
   B1's and B2's kernels on the 307 chunks of the tail slice, B9 the
   variant kernel at 128 MB and at 144 chunks; B1/B5 and B3 also at each launch shape of the
   step, alone, B7a and B7c at the shapes the step gives them under
   ``CGX_PALLAS_DB=on``, and B4 at phase 7's launch shapes, with its time
   and bound a rank-step of the two-level and the all-to-all scheme
   (``tools/shapebench.py``: cold inputs, back-to-back launches behind a
   sleep kernel, five groups in turns with the plain version); the four
   stochastic kernels beside their round-to-nearest selves
   (:func:`time_stochastic`, bound also by the Philox's integer work) and
   a profile of the stochastic step under ``CGX_PALLAS_DB`` off and on;
   the 16-bit instances alone against their byte bound
   (``shapebench.WIRE16_SHAPES``, :func:`time_wire16`), B8's tensor-core
   kernel in turns with its FFMA 16-bit instance, the f32 one and
   ``torch.matmul`` on the bf16 operands (:func:`time_mm16`), and the
   bf16-parameter step's time
   and profile beside the float32 one's;
5b. the int8 fold (``CGX_SRA_ACCUM=int8``), once its library is built
   (its instances' registers and spills beside their exact twins'):
   B3, B7c and B4's int8 instances against the int8 fold's plain versions
   on the card's tensors, bit for bit (:func:`check_int8`: the step's
   epilogue shapes, bits 1-8 on adversarial rows, both roundings, every
   lowering, buckets 512-16,384 past the register budget and the old
   epilogue gate through the batch functions and forced geometries, tiles
   and ring depths, bf16 and f16, B4 at phase 7's shapes and rows 1-8, 11
   at both widths; the one-row epilogue's bytes equal to the exact
   fold's); then the slice's steps from the seed under int8
   (:func:`int8_phase`): launches the layout's, every epilogue an int8
   instance, losses and parameters bit-identical to phase 4's exact steps
   (at one row every scale is 2^12); then the int8 instances beside the
   exact ones in turns (:func:`time_int8`: B3 and B7c at one row of the 64
   MB slice and at ws 4 x 256 chunks, B4 at phase 7's shapes and a
   rank-step) and a profile of the int8 step under ``CGX_PALLAS_DB`` off
   and on;
6. qbench: ``python -m torch_cgx_tpu_torch.tools.qbench`` at its defaults
   (128 MB, 4 bits, bucket 512, k = 8, ``sra_epilogue`` at ws 8) for each
   of its eight variants, in this process: each variant's bytes checked,
   then its time, GB/s and share of the bytes bound; ``current``,
   ``nometa``, ``metalane`` and ``read`` again at ``--mb 9`` (144 chunks,
   the step's mlp_in launch), then those four as bursts at both sizes, and
   B1's split (meta store, encode and pack, the rest) from both;
7. multi-rank: four spawned ranks share the card over a gloo group (NCCL
   refuses two ranks on one device), as a cross 2 x intra 2 layout, each
   with full-width GPT-2 124M and its own 2 x 512 token shard. The
   reference's default two-level scheme (intra SRA, cross Ring, leader
   scheme): one gradient sync through the kernels bit-identical to the
   same sync through the plain versions on the CPU; three train steps with
   the launch counters reset just before and read just after, held against
   the counts derived from the layout (no B4 launch at scalar width in any
   configuration); replicas bit-identical. Then one step
   each of the flat Ring, the all-to-all and the two-level scheme with an
   uncompressed intra level, the first two also held against the plain CPU
   path on a 64 MB fusion slice. Then the flat SRA on a float32 GPT-2 124M,
   one step without producer fusion and one with it
   (``CGX_PRODUCER_FUSE=on``), whose step skips the 36 plain weight
   gradients (``producer_dw_skipped``) and runs its 36 B8 launches on the
   tensor cores as split TF32 (``MM_TC_LAUNCHES``), each after a split
   pass (``LAUNCHES["codec_tf32_split"]``): before it, rank 0 runs one backward
   outside ``make_train_step`` with the plane engaged (``p.grad`` kept) and
   holds each of the 36 staged payloads (the
   ``attn_qkv``, ``mlp_in`` and ``mlp_out`` kernels of the 12 blocks) to a
   quantize of the exact (float64) product of the operands the layer's
   backward handed the kernel, ``/ 4``, within ``payload_close``'s
   tolerance, that product to the layer's ``p.grad`` within 1e-5 of its
   largest magnitude (cuBLAS's float32 ``p.grad`` itself moves the meta
   past 1e-5 there; its distances are logged). Then ``sra_producer_bf16``: the same on the default model
   (bf16 compute, f32 parameters): 36 B8 launches a rank, every one reading
   bf16 operands itself on the tensor-core kernel (``MM_TC_LAUNCHES``), 36
   ``dw`` skipped a rank, and rank 0's 36 payloads bit for bit against a
   direct launch on the operands of the same backward and within the
   payload tolerance of the plain version (:func:`producer_checks`). Then the flat SRA under ``CGX_PALLAS_DB=on``: the pipelined
   epilogue folds the four ranks' rows. Then ``ddp_hook``: the DDP comm
   hook (``torch_backend``) under ``DistributedDataParallel`` on a float32
   GPT-2 124M, four steps under SRA with the layers registered at step 2,
   every bucket reduced on the group's worker thread: the registry against
   ``should_compress_``, replicas bit-identical after every step, the
   hook's launches over steps 2-3 against ``LaunchModel.hook``, and step
   3's buckets (captured after the division) reduced again through the
   kernels and through the plain versions on the CPU over the same group,
   bit-identical under SRA with f32 buckets, and every fourth one of all
   but the last (``wte``'s) with bf16 buckets and under the all-to-all (the
   hook's Ring runs in ``ddp_hook_hier``'s cross stage). Then ``ddp_hook_hier``: the same on two faked hosts of two
   ranks (``CGX_SHM_HOST_ID=testhost{rank // 2}``) under the default
   two-level scheme (intra SRA, cross Ring, leader scheme): every rank takes
   the two-level path, the launches equal ``LaunchModel.hook`` on the
   leaders and the non-leaders, and step 3's buckets are bit-identical
   between the kernels and the plain CPU path under the default scheme
   with f32 buckets (every fourth one under cross SRA, cross all-to-all and
   ``CGX_INTRA_COMPRESS=0``; its bf16 buckets are ``ddp_hook``'s codec path),
   and the leaders' stage-3 frames identical. Then ``ddp_hook_sr`` and ``ddp_hook_hier_sr``: both again
   under ``CGX_STOCHASTIC_ROUNDING=1``, with the same checks (the reruns
   through the kernels and the plain versions drawing the same frame
   keys; every fourth bucket of all but the last). (Before ``ddp_hook``, after ``sra_db``: ``two_level_bf16p`` and
   ``alltoall_bf16p``, GPT-2 124M with its parameters in bf16, one step
   each, launches against the bf16 layout, every quantize and every B4
   launch with a raw own row reading bf16, a 64 MB bf16 slice through the
   kernels bit-identical to the plain CPU path, replicas bit-identical.)
   The ``_int8`` configurations (``two_level_int8``, ``alltoall_int8`` on
   the default model, ``sra_int8``, ``sra_db_int8`` on the float32 one)
   under ``CGX_SRA_ACCUM=int8``: one step each, launches against the
   layout and their int8 share (``INT8_LAUNCHES``) against
   :func:`expected_int8`'s, a 64 MB slice through the kernels bit-identical
   to the plain CPU path's int8 fold, replicas bit-identical. ``ddp_hook``
   reruns its buckets under ``CGX_SRA_ACCUM=int8`` too: no int8 instance
   runs and the bytes equal its exact rerun's (the hook folds exactly, as
   the JAX hook does).
   Error feedback and the nonfinite guard (:func:`ef_guard_check`):
   ``sra_ef`` (float32 model) and ``two_level_ef`` (default model), three
   steps of ``make_train_step(error_feedback=True)`` each, launches against
   the layout's with the round trip's (``LaunchModel.roundtrip``: the flat
   SRA one more B2 a fusion slice, the two-level leader scheme one more B1
   and B2), ``allreduce_flat(..., return_roundtrip=True)`` of a 64 MB slice
   through the kernels bit-identical to the plain CPU path, reduced and
   round trip, the slice's residual within half a unit of its bucket of
   the wire layout and 0 on the own row, the residuals after the steps
   nonzero, finite, float32; ``sra_guard_skip`` and ``sra_guard_exact``
   (float32 model, :func:`guard_run`): rank 2's loss scaled by NaN at step
   1 of three, the clean step 0 bit-identical to one unguarded step from
   the same snapshot, "skip" keeping the parameters and Adam's state bit
   for bit, "exact" changing them, finite, the counter 1 on rank 0 alone;
   replicas bit-identical throughout. ``sra``, ``sra_ef``, ``two_level``,
   ``two_level_ef``, ``sra_producer`` and ``sra_producer_bf16`` each profile
   one step on rank 0 (codec kernels, B8's device time, device busy).
   Gloo stages the wire through host memory: its time is not a card
   number.

The third-to-last line is the per-kernel JSON record, the second-to-last
the card's name and power limit, the last ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import multiprocessing as mp
import os
import queue
import re
import statistics
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np

SEED = 0
BITS = 4
BUCKET = 512
BATCH, SEQ = 8, 512
STEPS = 3
FLAT_N = 16_777_216  # a full 64 MB fusion slice: whole 32-bucket chunks
TAIL_N = 5_042_944  # the last wte slice: 307 chunks, 26 tail buckets, a partial bucket
SRA_WS = 4  # the stage-1 row count of the multi-rank epilogue check
MR_WS, MR_INTRA = 4, 2  # phase 7: 4 ranks, cross 2 x intra 2
MR_BATCH = 2  # each rank's token shard: 2 x 512, 8 x 512 in all
MR_STEPS = 3
MR_TIMEOUT_S = 600

# float32 outside the tensor cores, operations/s (H100 SXM data sheet).
F32_RATE = 67e12
# bf16 and f16 on the tensor cores, dense, operations/s (the same sheet):
# the least time the card needs for a product of 16-bit operands.
BF16_RATE = 989e12
# TF32 on the tensor cores, dense (the same sheet): B8's float32 operands
# run as split TF32, three tf32 products for each f32 one.
TF32_RATE = 495e12
# Stochastic rounding (phases 3, 4, 5 and 7): the seed of the kernels'
# checks and of the stochastic step.
SR_SEED = 0x0123456789ABCDEF
# The Philox's part of the stochastic kernels' bound (phase 5). Its
# instructions a value are read from the SASS of the build, beside phases
# 3 and 4 (:func:`philox_sass`): B1's stochastic instance at 4 bits, div,
# sum, one position (32 values) a thread, less the deterministic instance,
# over 32. From the code (csrc/codec.cu philox4x32_10) a call for four
# values is ten rounds of two 32 x 32 -> 64-bit multiplies (IMAD.WIDE, or
# IMAD.HI and IMAD) and two three-input XORs (LOP3), and nine key bumps of
# two adds that depend on the seed alone (once a thread); each value adds
# a shift, a convert and the scale's multiply. Each pipe's count is priced at its own rate, a
# Hopper SM's per clock (CUDA C++ Programming Guide, arithmetic
# throughput, compute capability 9.0): the integer ALU (logic, shifts,
# adds, compares, selects) 64, the integer multiply-add (IMAD, on the FMA
# pipe) 64, f32 add and multiply 128, the converts I2F, F2I, FRND 16;
# every instruction counts against the four schedulers' issue, 128. The
# bound takes the busiest pipe; an instruction of no listed pipe counts
# only in the issue.
SASS_PIPES = {
    "alu": (64, ("LOP3", "LOP", "SHF", "SHL", "SHR", "IADD3", "IADD", "LEA", "SEL", "ISETP",
                 "IMNMX", "PRMT", "FMNMX", "FSEL", "FSETP")),
    "imad": (64, ("IMAD",)),
    "fp32": (128, ("FADD", "FMUL", "FFMA")),
    "cvt": (16, ("I2F", "F2I", "FRND")),
    "issue": (128, None),
}
PHILOX_SASS_KERNEL = re.compile(r"cgx_quantize_cluster_kernelILi4ELi0ELi0ELb0ELb([01])EfE")
# B1's instance that B9's bodies are cut from (4 bits, div, sum, one
# position, round to nearest, f32) and those bodies, for variant_sass.
VARIANT_SASS_B1 = "cgx_quantize_cluster_kernelILi4ELi0ELi0ELb0ELb0EfE"
VARIANT_SASS_KERNELS = re.compile(
    rf"({VARIANT_SASS_B1}|cgx_quantize_variant_cluster_kernelILi4ELi[012]ELb0EE)")
# An H100 SXM: 132 SMs at the 1.98 GHz boost clock (NVIDIA's Hopper
# architecture white paper).
SM_CLOCK_RATE = 132 * 1.98e9
# Phase 3's stochastic buckets: at bits 1-8 (1760 and 16384 past the
# register budget); and (bucket, chunks) of the forced geometries.
SR_BUCKETS = (128, 512, 1760, 4096, 16384)
SR_FORCED = ((512, 6), (1760, 4), (16384, 2))
# The 16-bit wire dtypes (phases 3, 4 (g), 5, 7) and a 64 MB fusion slice
# of 2-byte values: 33,554,432, 2,048 chunks of bucket 512.
WIRE16 = ("bfloat16", "float16")
FLAT16_N = 2 * FLAT_N
# Phase 3's 16-bit checks at the step's shapes run bf16 alone: f16 takes
# the same instances with another convert, checked at every shape by the
# card tests (tests/test_torch_kernels.py, the subf32 tests); the script's
# time.
PHASE3_WIRE16 = ("bfloat16",)

TPU_KERNELS = {
    "codec_quantize": "torch_cgx_tpu/ops/codec_pallas.py:312,763",
    "codec_dequantize": "torch_cgx_tpu/ops/codec_pallas.py:389,815",
    "codec_sra_epilogue": "torch_cgx_tpu/ops/codec_pallas.py:1375",
    "codec_reduce_rows": "torch_cgx_tpu/ops/codec_pallas.py:1303",
    "codec_matmul_quantize": "torch_cgx_tpu/ops/fused_producer.py:537",
    "codec_quantize_db": "torch_cgx_tpu/ops/codec_pallas.py:505",
    "codec_dequantize_db": "torch_cgx_tpu/ops/codec_pallas.py:618",
    "codec_sra_epilogue_db": "torch_cgx_tpu/ops/codec_pallas.py:1473",
    "codec_quantize_variant": "tools/qbench.py:44,148",
    # B8's float32 operands split into TF32 planes for its tensor-core
    # kernel: part of the same TPU kernel.
    "codec_tf32_split": "torch_cgx_tpu/ops/fused_producer.py:537",
}
# The pipelined kernel of each single-stage one, by the batch functions'
# kernel names (``dispatch.db_would_run``).
DB_OF = {"codec_quantize": "quantize", "codec_dequantize": "dequantize",
         "codec_sra_epilogue": "epilogue"}
DB_CHUNKS = (1, 131, 133, 2053)  # around the persistent grid (132 SMs) and far above it
# Phase 6's second qbench size: ``--mb 9`` is 144 chunks of bucket 512, the
# step's mlp_in launch of B1 (a cluster of 4 CTAs a chunk), beside the
# default 128 MB (2,048 chunks, one CTA a chunk). The variants run at both
# split B1's time: current - nometa its meta store, nometa - read its encode
# and pack.
QBENCH_MB = 128  # qbench's default
QBENCH_STEP_MB = 9
QBENCH_STEP_CHUNKS = QBENCH_STEP_MB * 2**20 // (4 * 32 * BUCKET)
QBENCH_SPLIT = ("current", "nometa", "metalane", "read")
QBENCH_GROUPS = 5  # burst groups a variant and size, in turns
QBENCH_LAUNCHES = 32  # launches a burst
# The dense layers of GPT-2 124M whose weight gradients producer fusion
# quantizes in phase 7 (weight shape (din, o)), with the contraction of a
# rank's 2 x 512 tokens. attn_proj (768 x 768) is below
# CGX_STANDALONE_LAYER_ELEMS and stays in the fused group.
MM_SHAPES = {"mlp_in": (768, 3072), "attn_qkv": (768, 2304), "mlp_out": (3072, 768)}
MM_K = MR_BATCH * SEQ
# (K, din, o, divisor, bits, bucket) of the matmul-quantize's edge cases:
# o not a multiple of the 128-column tile (448, 1344, 672), din not a
# multiple of the 64-row tile (100) or of 4 (13), K not a multiple of the
# 16-step stage, buckets 128, 512 and 896, chunks that cross rows.
MM_EDGE_CASES = [
    (96, 64, 448, 2, 1, 128), (77, 256, 1344, 4, 8, 512), (130, 128, 672, 4, 4, 896),
    (50, 100, 4096, 4, 1, 128), (33, 13, 4096, 2, 3, 128), (1024, 128, 896, 4, 8, 896),
]
META_RTOL = 1e-5
RAW_RTOL = 1e-5
SOURCE = "torch_cgx_tpu_torch/csrc/codec.cu"
# B8 on 16-bit operands (bf16 or f16 read by the kernel; at GPT-2 124M's
# shapes the tensor-core kernel, cgx_matmul_quantize_tc_kernel): a record of
# its own in the kernels line, beside the f32 one, its launches those of the
# tensor-core kernel (MM_TC_LAUNCHES). The JAX kernel reads its operands in
# the layer's compute dtype (fused_producer.py:573-576).
MM16 = "codec_matmul_quantize_bf16"
MM16_REPLACES = "torch_cgx_tpu/ops/fused_producer.py:537 (bf16/f16 x2, g2: :573-576)"


_PHASE: dict = {}


def phase(title: str) -> None:
    """Log the seconds the previous phase took (host clock), then open
    ``title`` (``"N. ..."``)."""
    now = time.perf_counter()
    if _PHASE:
        log(f"  phase {_PHASE['n']} took {now - _PHASE['t']:.1f} s")
    log(f"== {title}")
    _PHASE.update(n=title.split(".")[0], t=now)


def log(*args) -> None:
    print(*args, flush=True)


def fuzz_operand(rng, n, kind):
    """The cross-implementation codec fuzz recipes: normal data, extreme
    magnitudes with denormal-scale spikes, constant runs with outliers."""
    if kind == 0:
        return rng.standard_normal(n).astype(np.float32)
    if kind == 1:
        x = (rng.standard_normal(n) * 1e30).astype(np.float32)
        x[:: max(1, n // 7)] = 1e-38
        return x
    x = np.full(n, -7.25, np.float32)
    x[:: max(1, n // 5)] = 3.5
    return x


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------


def _same_bits(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype in (torch.bfloat16, torch.float16):
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def _max_abs(a, b) -> float:
    import torch

    if a.dtype == torch.int32:
        return float((a != b).sum())
    if not a.numel():
        return 0.0
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))  # equal infinities and NaNs: no error
    return float(torch.where(same, 0.0, (a.double() - b.double()).abs()).max())


def payload_close(words, meta, want_words, want_meta, bits: int, bucket: int) -> tuple:
    """Two quantized payloads of nearly equal values (one product summed in
    two orders) against the tolerance: every meta value within ``META_RTOL``
    relative to the larger of its magnitude and its bucket's level step, and
    every decoded value within one level step of the other's, plus what the
    meta's own difference moves it. Returns ``(ok, largest meta relative
    error, largest decoded difference, largest decoded difference in level
    steps)``."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda

    m = meta.reshape(-1, 2).double()
    wm = want_meta.reshape(-1, 2).double()
    unit = wm[:, 0]
    dm = (m - wm).abs()
    scale = torch.maximum(wm.abs(), unit[:, None]).clamp_min(1e-30)
    meta_rel = float((dm / scale).max())

    def decode(w, mt):
        return codec_cuda.dequantize_chunks(
            w.reshape(-1).contiguous(), mt.reshape(-1, 2).contiguous(), bits, bucket
        ).double().view(-1, bucket)

    a, b = decode(words, meta), decode(want_words, want_meta)
    err = (a - b).abs()
    # One level step, the meta's difference, and the float32 roundings of
    # each decode, min + unit * level: the product's and the sum's, at most
    # eps (|value| + |min|) a value (the product is near |min| where the
    # value is near 0).
    tol = (unit + dm[:, 1] + ((1 << bits) - 1) * dm[:, 0])[:, None]
    mins = torch.maximum(m[:, 1].abs(), wm[:, 1].abs())[:, None]
    tol = tol + 2 * np.finfo(np.float32).eps * (torch.maximum(a.abs(), b.abs()) + mins)
    ok = meta_rel <= META_RTOL and bool((err <= tol).all())
    steps = float((err / unit.clamp_min(1e-30)[:, None]).max())
    return ok, meta_rel, float(err.max()), steps


def check_kernels(dev, flat_n: int, tail_n: int, ws: int) -> dict:
    """Each kernel wrapper against its plain version on the same inputs.
    Raises on the first difference: the tolerance is 0. Returns each
    kernel's largest absolute difference over its checks (differing words
    count for the integer outputs)."""
    import torch

    from torch_cgx_tpu_torch.ops import codec, codec_cuda

    rng = np.random.default_rng(SEED)
    max_err = {k: 0.0 for k in (*TPU_KERNELS, MM16)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def record(kernel: str, label: str, got, want, single=None, quiet: bool = False) -> None:
        """``got`` against the plain version's ``want`` and, for a
        pipelined kernel, against its single-stage sibling's ``single``
        (``quiet``: no line for an agreeing pair; the caller sums up)."""
        err = _max_abs(got, want) if got.shape == want.shape else float("inf")
        max_err[kernel] = max(max_err[kernel], err)
        if not _same_bits(got, want):
            raise AssertionError(
                f"{kernel} {label}: kernel disagrees with its plain version (max error {err})"
            )
        if single is not None and not _same_bits(got, single):
            raise AssertionError(f"{kernel} {label}: kernel disagrees with the single-stage kernel")
        also = " (and the single-stage kernel)" if single is not None else ""
        if not quiet:
            log(f"  {kernel:21s} {label:44s} bit-identical{also}")

    def db_tc(kernel: str, chunks: int, bits: int, b: int, add: bool = False) -> int:
        """The tile the batch functions give the pipelined kernel (no
        tuned entry), 0 where its ring does not fit (ROADMAP C7)."""
        cap = codec_cuda.db_tc_cap(DB_OF[kernel], bits, b, with_add=add, chunks=chunks, sms=sms)
        return codec_cuda._pipe_tc(chunks, cap) if cap >= 1 else 0

    def check_db(label: str, x, bits: int, b: int, acc, want, q, q_acc, ep) -> None:
        """The pipelined kernels on one flat buffer ``x`` of whole chunks:
        ``want`` its plain quantize, ``q`` and ``q_acc`` the single-stage
        payload and decode (with ``acc`` added), ``ep`` the single-stage
        rows=1 epilogue."""
        chunks = x.numel() // (32 * b)
        tc = db_tc("codec_quantize", chunks, bits, b)
        if tc:
            w, m = codec_cuda.quantize_chunks_db(x, bits, b, tc)
            record("codec_quantize_db", f"{label} tc={tc} words", w, want.packed, q.packed[0])
            record("codec_quantize_db", f"{label} tc={tc} meta", m, want.meta, q.meta[0])
        else:
            log(f"  {'codec_quantize_db':21s} {label:44s} gated (C7): single-stage kernel")
        w, m = q.packed[0], q.meta[0]
        for add, single in ((None, codec_cuda.dequantize_batch(q)[0]), (acc, q_acc)):
            tc = db_tc("codec_dequantize", chunks, bits, b, add is not None)
            lab = label + (" add_to" if add is not None else "")
            if tc:
                got = codec_cuda.dequantize_chunks_db(w, m, bits, b, tc, add_to=add)
                record("codec_dequantize_db", f"{lab} tc={tc}", got,
                       codec.dequantize(want, add_to=add), single)
            else:
                log(f"  {'codec_dequantize_db':21s} {lab:44s} gated (C7): single-stage kernel")
        tc = db_tc("codec_sra_epilogue", chunks, bits, b)
        if ep is not None and tc:
            got_w, got_m = codec_cuda.sra_epilogue_chunks_db(q.packed, q.meta, None, -1, bits, b, tc)
            pw, pm = codec_cuda.sra_epilogue_chunks_db_plain(q.packed, q.meta, None, -1, bits, b)
            record("codec_sra_epilogue_db", f"{label} rows=1 tc={tc} words", got_w, pw, ep.packed[0])
            record("codec_sra_epilogue_db", f"{label} rows=1 tc={tc} meta", got_m, pm, ep.meta[0])

    cases = [(flat_n, b, BUCKET, 0) for b in (1, 2, 4, 8)]
    cases += [(flat_n, BITS, BUCKET, 1), (flat_n, BITS, BUCKET, 2)]
    cases += [(tail_n, BITS, BUCKET, k) for k in (0, 1, 2)]
    cases += [(flat_n // 4, BITS, 1024, 0), (tail_n // 4, 3, 96, 0)]
    cases += [(c * 32 * BUCKET, BITS, BUCKET, 0) for c in DB_CHUNKS]
    for n, bits, b, kind in cases:
        x = torch.from_numpy(fuzz_operand(rng, n, kind)).to(dev)
        label = f"n={n} bits={bits} B={b} recipe={kind}"
        q = codec_cuda.quantize_batch(x[None], bits, b)
        want = codec.quantize(x, bits, b)
        record("codec_quantize", label + " words", q.packed[0], want.packed)
        record("codec_quantize", label + " meta", q.meta[0], want.meta)
        acc = torch.from_numpy(fuzz_operand(rng, n, 0)).to(dev)
        record("codec_dequantize", label, codec_cuda.dequantize_batch(q)[0], codec.dequantize(want))
        q_acc = codec_cuda.dequantize_batch(q, add_to=acc[None])[0]
        record("codec_dequantize", label + " add_to", q_acc, codec.dequantize(want, add_to=acc))
        ep = None
        if codec_cuda.supports_reduce(q):
            ep = codec_cuda.sra_epilogue_batch(q)
            w, m = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, None, -1, bits, b)
            record("codec_sra_epilogue", label + " rows=1 words", ep.packed[0], w)
            record("codec_sra_epilogue", label + " rows=1 meta", ep.meta[0], m)
        if n % (32 * b) == 0 and b % 128 == 0:
            check_db(label, x, bits, b, acc, want, q, q_acc, ep)

    # The multi-rank epilogue: ws stage-1 rows of one rank's chunk, the raw
    # own row swapped in for each position it can take; the pipelined one
    # at phase 7's flat-SRA shape.
    chunk = flat_n // ws
    rows = torch.from_numpy(
        np.stack([fuzz_operand(rng, chunk, 0) * (r + 1) for r in range(ws)])
    ).to(dev)
    qs = codec_cuda.quantize_batch(rows, BITS, BUCKET)
    tc = db_tc("codec_sra_epilogue", chunk // (32 * BUCKET), BITS, BUCKET)
    for own in range(ws):
        got = codec_cuda.sra_epilogue_batch(qs, raw_row=rows[own], own_idx=own)
        w, m = codec_cuda.sra_epilogue_chunks_plain(
            qs.packed, qs.meta, rows[own], own, BITS, BUCKET
        )
        label = f"ws={ws} own={own} n={chunk}"
        record("codec_sra_epilogue", label + " words", got.packed[0], w)
        record("codec_sra_epilogue", label + " meta", got.meta[0], m)
        dw, dm = codec_cuda.sra_epilogue_chunks_db(qs.packed, qs.meta, rows[own], own, BITS, BUCKET, tc)
        record("codec_sra_epilogue_db", f"{label} tc={tc} words", dw, w, got.packed[0])
        record("codec_sra_epilogue_db", f"{label} tc={tc} meta", dm, m, got.meta[0])
    del qs, rows

    # The multi-row reduce at other widths, recipes, and a bucket past the
    # old epilogue gate (phase 7's shapes: check_reduce).
    cases = [(4, flat_n // 4, b, BUCKET, 0, [2]) for b in (1, 8)]
    cases += [(2, flat_n // 8, BITS, BUCKET, k, [1]) for k in (1, 2)]
    cases += [(3, 4 * 32 * 2048, BITS, 2048, 0, [None, 1])]
    for rows_n, n, bits, b, kind, owns in cases:
        rows = torch.from_numpy(
            np.stack([fuzz_operand(rng, n, kind) * np.float32(r + 1) for r in range(rows_n)])
        ).to(dev)
        q = codec_cuda.quantize_batch(rows, bits, b)
        assert codec_cuda.supports_reduce(q)
        for own in owns:
            raw = None if own is None else rows[own]
            got = codec_cuda.reduce_rows_batch(q, raw_row=raw, own_idx=own)
            want = codec_cuda.reduce_rows_chunks_plain(
                q.packed, q.meta, raw, -1 if own is None else own, bits, b
            )
            label = f"rows={rows_n} n={n} bits={bits} B={b} recipe={kind} own={own}"
            record("codec_reduce_rows", label, got, want)
        del rows, q

    # The matmul-quantize at the dense-layer shapes of phase 7's flat SRA
    # step, divisor 4, then at geometries whose tiles (128 x 192 values of
    # dw on the tensor cores, 64 x 128 on the FFMA kernel) and 32-bucket
    # chunks end at different places: o not a multiple of the tile's
    # width, din not a multiple of its height (or of 4), K not a multiple
    # of the stage, chunks that cross rows. float32 operands take the
    # tensor cores as split TF32 (the split pass, then three tf32 products
    # a step: check_mm32), and the FFMA kernel, forced, keeps its anchor.
    # Small-integer operands make every sum exact in f32 (and every lo
    # plane 0), so the kernels' and cuBLAS's orders agree and the bytes
    # must too, the own raw row's values included; normal operands are
    # held to payload_close's tolerance, their raw row to RAW_RTOL
    # relative to the row's largest magnitude (one product summed in two
    # orders).
    max_err["codec_matmul_quantize"] = max(max_err["codec_matmul_quantize"], check_mm32(dev, rng, record))
    check_b9(dev, flat_n, record)
    check_lowerings(dev, flat_n, ws, rng, record, db_tc)
    check_cluster(dev, rng, record)
    check_reduce(dev, rng, record)
    check_stochastic(dev, flat_n, rng, record, db_tc)
    check_subf32(dev, flat_n, tail_n, rng, record)
    max_err[MM16] = max(max_err[MM16], check_mm16(dev, rng, record))
    return max_err


def check_mm32(dev, rng, record) -> float:
    """B8's float32 operands at phase 7's three dense-layer shapes (K =
    MM_K, divisor MR_WS) and at MM_EDGE_CASES, the own raw row of one rank:
    on the tensor cores (split TF32; each launch counted in
    ``MM_TC_LAUNCHES`` and its split pass in ``LAUNCHES["codec_tf32_split"]``)
    and on the FFMA kernel (``_route="ffma"``). Integer operands: words,
    meta and raw row bit-identical to the plain version on both routes.
    Normal operands: both within ``payload_close``'s tolerance of it and
    the raw row within RAW_RTOL of its largest magnitude; the tensor
    cores' meta error is printed beside the FFMA kernel's. The split pass
    against its plain version, bit for bit, at the three shapes. Returns
    the largest decoded difference of the tensor-core route from the plain
    version on normal operands."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda

    def routed(fn, route):
        tc, split = codec_cuda.MM_TC_LAUNCHES["launches"], codec_cuda.LAUNCHES["codec_tf32_split"]
        out = fn()
        took = (codec_cuda.MM_TC_LAUNCHES["launches"] - tc, codec_cuda.LAUNCHES["codec_tf32_split"] - split)
        if took != ((1, 1) if route == "tc" else (0, 0)):
            raise AssertionError(f"codec_matmul_quantize: expected the {route} route, the launches were {took}")
        return out

    worst = 0.0
    errs = {"tc": [], "ffma": []}
    cases = [(layer, MM_K, din, o, MR_WS, BITS, BUCKET) for layer, (din, o) in MM_SHAPES.items()]
    cases += [("edge", *c) for c in MM_EDGE_CASES]
    for layer, k, din, o, div, bits, b in cases:
        label = f"{layer} K={k} {din}x{o} div={div} bits={bits} B={b}"
        ws = MR_WS if din % MR_WS == 0 else 1
        own = ((din // 3) * ws // din if ws > 1 else 0, ws)  # a row inside the layer
        for kind in ("integer", "normal"):
            if kind == "integer":
                xm = rng.integers(-3, 4, (k, din)).astype(np.float32)
                gm = rng.integers(-3, 4, (k, o)).astype(np.float32)
            else:
                xm = rng.standard_normal((k, din)).astype(np.float32)
                gm = rng.standard_normal((k, o)).astype(np.float32)
            x2, g2 = torch.from_numpy(xm).to(dev), torch.from_numpy(gm).to(dev)
            pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(x2, g2, div, bits, b, own_row=own)
            if kind == "integer" and layer != "edge":
                xs, gs = codec_cuda.tf32_split_transpose(x2, g2)
                pxs, pgs = codec_cuda.tf32_split_transpose_plain(x2, g2)
                record("codec_tf32_split", f"{label} integer x2 planes", xs, pxs, quiet=True)
                record("codec_tf32_split", f"{label} integer g2 planes", gs, pgs, quiet=True)
                xn = torch.from_numpy(rng.standard_normal((k, din)).astype(np.float32)).to(dev)
                gn = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32)).to(dev)
                xs, gs = codec_cuda.tf32_split_transpose(xn, gn)
                pxs, pgs = codec_cuda.tf32_split_transpose_plain(xn, gn)
                record("codec_tf32_split", f"{label} normal x2 planes", xs, pxs, quiet=True)
                record("codec_tf32_split", f"{label} normal g2 planes", gs, pgs, quiet=True)
            for route in ("tc", "ffma"):
                w, m, raw = routed(lambda: codec_cuda.matmul_quantize_chunks(
                    x2, g2, div, bits, b, own_row=own, _route=None if route == "tc" else "ffma"), route)
                if kind == "integer":
                    record("codec_matmul_quantize", f"{label} integer words ({route})", w, pw, quiet=True)
                    record("codec_matmul_quantize", f"{label} integer meta ({route})", m, pm, quiet=True)
                    record("codec_matmul_quantize", f"{label} integer raw row {own[0]}/{ws} ({route})", raw,
                           praw, quiet=True)
                    continue
                ok, meta_rel, abs_err, steps = payload_close(w, m, pw, pm, bits, b)
                raw_rel = _max_abs(raw, praw) / max(float(praw.abs().max()), 1e-30)
                errs[route].append(meta_rel)
                if route == "tc":
                    worst = max(worst, abs_err)
                log(f"  {'codec_matmul_quantize':20s} {label + ' normal (' + route + ')':50s} meta {meta_rel:.2e} "
                    f"rel, decoded within {steps:.3f} level steps ({abs_err:.3e}); raw row {raw_rel:.2e} rel")
                if not ok or raw_rel > RAW_RTOL:
                    raise AssertionError(f"codec_matmul_quantize {label} ({route}): outside the tolerance")
    log(f"  codec_matmul_quantize float32: integer words, meta, raw row bit-identical to the plain version "
        f"on both routes at {len(cases)} shapes; normal meta error on the tensor cores (split TF32) "
        f"{min(errs['tc']):.2e}-{max(errs['tc']):.2e} relative, on the FFMA kernel "
        f"{min(errs['ffma']):.2e}-{max(errs['ffma']):.2e} (META_RTOL {META_RTOL:g}); the split pass "
        f"bit-identical to its plain version at the three shapes")
    return worst


def _ulp16(v, dtype):
    """One unit in the last place of ``dtype`` (bf16 or f16) at each
    magnitude of ``v`` (float64; the smallest normal's below it)."""
    import torch

    fi = torch.finfo(dtype)
    mant = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    _, e = torch.frexp(v.abs().clamp(min=fi.tiny))
    return torch.ldexp(torch.ones_like(v), e - 1 - mant)


def check_mm16(dev, rng, record) -> float:
    """B8's 16-bit operands at phase 7's three dense-layer shapes (K =
    MM_K, divisor MR_WS, the own raw row of rank 1 of MR_WS), bf16 and f16,
    where the tensor-core kernel runs (every launch counted in
    ``MM_TC_LAUNCHES``): on small-integer operands (every partial sum
    exact) words, meta and raw row bit-identical to the plain version; on
    normal operands words and meta within ``payload_close``'s tolerance of
    it (the f32 check's), the raw row within RAW_RTOL of the row's largest
    magnitude plus one unit in the last place of the operand dtype (both
    round an f32 sum, summed in two orders). The FFMA kernel, forced with
    ``_route="ffma"``, on the same operands: bit-identical to the plain
    version on integer ones, and to the upcast route on normal ones (the
    FFMA f32 instance, forced, on ``x2.float()`` and ``g2.float()`` for
    words and meta,
    that route's sums at divisor 1 rounded to the operand dtype, then
    divided, for the raw row). Then bf16 operands at MM_EDGE_CASES and in a
    view 2 bytes off its alignment: integer ones bit-identical to the plain
    version, the tensor-core kernel where din and o are multiples of 8 and
    the operands aligned, the FFMA kernel elsewhere (din 13 and 100, the
    view). Returns the largest decoded difference from the plain version on
    normal operands."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda

    def routed(fn, route):
        before = codec_cuda.MM_TC_LAUNCHES["launches"]
        out = fn()
        took = "tc" if codec_cuda.MM_TC_LAUNCHES["launches"] > before else "ffma"
        if took != route:
            raise AssertionError(f"{MM16}: expected the {route} route, the launch took {took}")
        return out

    worst = 0.0
    own = (1, MR_WS)
    for dtype_name in WIRE16:
        dt = getattr(torch, dtype_name)
        for layer, (din, o) in MM_SHAPES.items():
            label = f"{layer} K={MM_K} {din}x{o} {dtype_name}"
            tiles = codec_cuda.mm_tc_tiles(din, o)
            xi, gi = (torch.from_numpy(rng.integers(-3, 4, (MM_K, c)).astype(np.float32)).to(dt).to(dev)
                      for c in (din, o))
            pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(xi, gi, MR_WS, BITS, BUCKET, own_row=own)
            for force, route in ((None, "tc"), ("ffma", "ffma")):
                w, m, raw = routed(lambda: codec_cuda.matmul_quantize_chunks(
                    xi, gi, MR_WS, BITS, BUCKET, own_row=own, _route=force), route)
                record(MM16, f"{label} integer words ({route})", w, pw, quiet=True)
                record(MM16, f"{label} integer meta ({route})", m, pm, quiet=True)
                record(MM16, f"{label} integer raw row ({route})", raw, praw, quiet=True)
            xn, gn = (torch.from_numpy(rng.standard_normal((MM_K, c)).astype(np.float32)).to(dt).to(dev)
                      for c in (din, o))
            w, m, raw = routed(lambda: codec_cuda.matmul_quantize_chunks(
                xn, gn, MR_WS, BITS, BUCKET, own_row=own), "tc")
            pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(xn, gn, MR_WS, BITS, BUCKET, own_row=own)
            ok, meta_rel, abs_err, steps = payload_close(w, m, pw, pm, BITS, BUCKET)
            r64, p64 = raw.double(), praw.double()
            tol = _ulp16(torch.maximum(r64.abs(), p64.abs()), dt) + RAW_RTOL * float(p64.abs().max())
            raw_ulps = float(((r64 - p64).abs() / _ulp16(p64, dt)).max())
            raw_ok = bool(((r64 - p64).abs() <= tol).all())
            worst = max(worst, abs_err)
            fw, fm, fraw = routed(lambda: codec_cuda.matmul_quantize_chunks(
                xn, gn, MR_WS, BITS, BUCKET, own_row=own, _route="ffma"), "ffma")
            uw, um = codec_cuda.matmul_quantize_chunks(xn.float(), gn.float(), MR_WS, BITS, BUCKET,
                                                       _route="ffma")
            _, _, sums = codec_cuda.matmul_quantize_chunks(xn.float(), gn.float(), 1, BITS, BUCKET,
                                                           own_row=own, _route="ffma")
            record(MM16, f"{label} FFMA words vs the upcast route", fw, uw, quiet=True)
            record(MM16, f"{label} FFMA meta vs the upcast route", fm, um, quiet=True)
            record(MM16, f"{label} FFMA raw row vs the upcast route", fraw, sums.to(dt).float() / MR_WS,
                   quiet=True)
            log(f"  {MM16:21s} {label:40s} tensor cores ({tiles[0]} x {tiles[1]} = {tiles[0] * tiles[1]} "
                f"tiles of {codec_cuda.MM_TC_TILE}): integer words, meta, raw row bit-identical to the "
                f"plain version; normal: meta {meta_rel:.2e} rel, decoded within {steps:.3f} level steps "
                f"({abs_err:.3e}), raw row within {raw_ulps:.2f} units of {dtype_name}; FFMA: integer "
                f"bit-identical to the plain version, normal bit-identical to the upcast route")
            if not ok or not raw_ok:
                raise AssertionError(f"{MM16} {label}: outside the tolerance of the plain version")
    # The edge shapes: K, din and o tails on the tensor cores (TMA's zero
    # fill), the FFMA kernel where TMA cannot describe the operands.
    dt = torch.bfloat16
    edges = [(k, din, o, div, bits, b, 0) for k, din, o, div, bits, b in MM_EDGE_CASES]
    edges.append((64, 256, 512, 2, 4, 512, 1))  # both operands 2 bytes off their 16-byte alignment
    routes = []
    for k, din, o, div, bits, b, offset in edges:
        def operand(rows, cols):
            v = torch.from_numpy(rng.integers(-3, 4, (rows, cols)).astype(np.float32)).to(dt).to(dev)
            buf = torch.empty(rows * cols + offset, dtype=dt, device=dev)
            buf[offset:].view(rows, cols).copy_(v)
            return buf[offset:].view(rows, cols)

        x2, g2 = operand(k, din), operand(k, o)
        route = "tc" if din % 8 == 0 and o % 8 == 0 and offset == 0 else "ffma"
        ws = MR_WS if din % MR_WS == 0 else 1
        w, m, raw = routed(lambda: codec_cuda.matmul_quantize_chunks(
            x2, g2, div, bits, b, own_row=(ws - 1, ws)), route)
        pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(x2, g2, div, bits, b, own_row=(ws - 1, ws))
        label = f"edge K={k} {din}x{o} div={div} bits={bits} B={b} offset={offset} bfloat16 ({route})"
        record(MM16, f"{label} integer words", w, pw, quiet=True)
        record(MM16, f"{label} integer meta", m, pm, quiet=True)
        record(MM16, f"{label} integer raw row", raw, praw, quiet=True)
        routes.append(f"{din}x{o}{'+' if offset else ''} {route}")
    log(f"  {MM16:21s} edge shapes bit-identical to the plain version on integer operands, on the "
        f"route their shape takes: {', '.join(routes)}")
    return worst


def check_stochastic(dev, flat_n: int, rng, record, db_tc) -> None:
    """The four quantizing kernels under stochastic rounding (a seed) against
    their plain versions on the card's tensors, bit for bit: B1 and B7a on
    the 64 MB slice in every (encode, pack) lowering, B7a's bytes equal to
    B1's; B3 and B7c at ws 1, 4 and 8 rows of a slice's chunk, with and
    without the raw own row, B7c's bytes equal to B3's; the fused epilogue
    (``dispatch.reduce_rows_requantize``) equal to the staged one (decode,
    sum, then B1); at each launch shape of the step (``shapebench.SHAPES``); at bits
    1-8 and buckets 128-16384 (positions in rounds past the register
    budget); at every cluster size forced, tiles of one and two chunks and
    ring depths 1-8 of B7a and B7c. Then the distribution on the card: every
    level is floor(q) or floor(q) + 1, and over 64 seeds the decode's mean
    error, summed over the values, is within 4 sigma of zero."""
    import torch

    from torch_cgx_tpu_torch.config import CompressionConfig
    from torch_cgx_tpu_torch.ops import codec, codec_cuda, dispatch
    from torch_cgx_tpu_torch.tools import shapebench
    from torch_cgx_tpu_torch.utils import prng

    t0 = time.perf_counter()
    lowerings = [(e, p) for e in codec_cuda.ENCODES for p in codec_cuda.PACKS]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sd = SR_SEED
    chunks = flat_n // (32 * BUCKET)
    x = torch.from_numpy(fuzz_operand(rng, flat_n, 0)).to(dev)
    tc = db_tc("codec_quantize", chunks, BITS, BUCKET)
    det = codec_cuda.quantize_chunks(x, BITS, BUCKET)[0]
    for enc, pack in lowerings:
        label = f"stochastic n={flat_n} {enc}/{pack}"
        pw, pm = codec_cuda.quantize_chunks_plain(x, BITS, BUCKET, encode=enc, seed=sd)
        w, m = codec_cuda.quantize_chunks(x, BITS, BUCKET, encode=enc, pack=pack, seed=sd)
        record("codec_quantize", label + " words", w, pw)
        record("codec_quantize", label + " meta", m, pm)
        dw, dm = codec_cuda.quantize_chunks_db(x, BITS, BUCKET, tc, encode=enc, pack=pack, seed=sd)
        record("codec_quantize_db", f"{label} tc={tc} words", dw, pw, w)
        record("codec_quantize_db", f"{label} tc={tc} meta", dm, pm, m)
    if _same_bits(w, det):
        raise AssertionError("stochastic rounding left the 64 MB slice's bytes as round-to-nearest's")

    # The epilogue at ws 1, 4 and 8 rows of one rank's chunk of the slice.
    for ws in (1, SRA_WS, 8):
        c = flat_n // ws
        rows = torch.from_numpy(np.stack([fuzz_operand(rng, c, 0) * np.float32(r + 1)
                                          for r in range(ws)])).to(dev)
        q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
        te = db_tc("codec_sra_epilogue", c // (32 * BUCKET), BITS, BUCKET)
        for own in (-1, ws // 2):
            raw = rows[own] if own >= 0 else None
            lows = lowerings if (ws, own) == (SRA_WS, SRA_WS // 2) else [("div", "sum")]
            for enc, pack in lows:
                label = f"stochastic ws={ws} own={own} n={c} {enc}/{pack}"
                pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, raw, own, BITS,
                                                              BUCKET, encode=enc, seed=sd)
                w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, raw, own, BITS, BUCKET,
                                                      encode=enc, pack=pack, seed=sd)
                record("codec_sra_epilogue", label + " words", w, pw)
                record("codec_sra_epilogue", label + " meta", m, pm)
                dw, dm = codec_cuda.sra_epilogue_chunks_db(q.packed, q.meta, raw, own, BITS, BUCKET,
                                                           te, encode=enc, pack=pack, seed=sd)
                record("codec_sra_epilogue_db", f"{label} tc={te} words", dw, pw, w)
                record("codec_sra_epilogue_db", f"{label} tc={te} meta", dm, pm, m)
        if ws == SRA_WS:
            # The fused epilogue against the staged one (decode, sum, then
            # B1), as the dispatcher runs them, with a key.
            cc = CompressionConfig(bits=BITS, bucket_size=BUCKET, stochastic=True)
            key = prng.key(sd)
            got = {}
            for mode in ("fused", "staged"):
                os.environ["CGX_SRA_EPILOGUE"] = mode
                got[mode] = dispatch.reduce_rows_requantize(q, cc, raw_rows=rows, own_idx=1, key=key)
            del os.environ["CGX_SRA_EPILOGUE"]
            for part in ("packed", "meta"):
                if not _same_bits(getattr(got["fused"], part), getattr(got["staged"], part)):
                    raise AssertionError(f"stochastic fused epilogue's {part} differs from the staged one's")
            log(f"  {'codec_sra_epilogue':21s} {'stochastic fused = staged (decode, sum, B1), ws=4':44s} "
                f"bit-identical")
        del rows, q

    # The step's launch shapes, every lowering.
    for kernel, label, ch, rows_n, own in shapebench.SHAPES:
        n = ch * 32 * BUCKET
        rows = torch.from_numpy(
            np.stack([fuzz_operand(rng, n, 0) * np.float32(r + 1) for r in range(rows_n)])).to(dev)
        raw = rows[own] if own >= 0 else None
        q = codec_cuda.quantize_batch(rows, BITS, BUCKET) if "epilogue" in kernel else None
        for enc, pack in lowerings:
            lab = f"stochastic {label} {enc}/{pack}"
            if kernel in ("quantize", "quantize_db"):
                pw, pm = codec_cuda.quantize_chunks_plain(rows[0], BITS, BUCKET, encode=enc, seed=sd)
                if kernel == "quantize":
                    w, m = codec_cuda.quantize_chunks(rows[0], BITS, BUCKET, encode=enc, pack=pack, seed=sd)
                else:
                    w, m = codec_cuda.quantize_chunks_db(rows[0], BITS, BUCKET, 1, encode=enc,
                                                         pack=pack, seed=sd)
            else:
                pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, raw, own, BITS, BUCKET,
                                                              encode=enc, seed=sd)
                if kernel == "epilogue":
                    w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, raw, own, BITS, BUCKET,
                                                          encode=enc, pack=pack, seed=sd)
                else:
                    w, m = codec_cuda.sra_epilogue_chunks_db(q.packed, q.meta, raw, own, BITS,
                                                             BUCKET, 1, encode=enc, pack=pack, seed=sd)
            name = "codec_" + {"quantize": "quantize", "quantize_db": "quantize_db",
                               "epilogue": "sra_epilogue", "epilogue_db": "sra_epilogue_db"}[kernel]
            record(name, lab + " words", w, pw, quiet=True)
            record(name, lab + " meta", m, pm, quiet=True)
        del rows, q
    log(f"  {'stochastic':21s} {len(shapebench.SHAPES)} launch shapes of the step x 4 lowerings bit-identical")

    # Widths 1-8 at buckets 128-16384 (1760 and 16384 past the register
    # budget), B1 and B3 (ws 1 and 8, raw row or not) in every lowering.
    checked = 0
    for bits in range(1, 9):
        for b in SR_BUCKETS:
            n = 3 * 32 * b
            xs = torch.from_numpy(fuzz_operand(rng, n, 0)).to(dev)
            rows = torch.stack([xs] + [torch.from_numpy(fuzz_operand(rng, n, 0)).to(dev)
                                       for _ in range(7)])
            q8 = codec_cuda.quantize_batch(rows, bits, b)
            q1 = codec_cuda.quantize_batch(rows[:1], bits, b)
            for enc, pack in lowerings:
                lab = f"stochastic c=3 bits={bits} B={b} {enc}/{pack}"
                pw, pm = codec_cuda.quantize_chunks_plain(xs, bits, b, encode=enc, seed=sd)
                w, m = codec_cuda.quantize_chunks(xs, bits, b, encode=enc, pack=pack, seed=sd)
                record("codec_quantize", lab + " words", w, pw, quiet=True)
                record("codec_quantize", lab + " meta", m, pm, quiet=True)
                for q, own in ((q1, -1), (q1, 0), (q8, -1), (q8, 5)):
                    raw = rows[own] if own >= 0 else None
                    pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, raw, own, bits, b,
                                                                  encode=enc, seed=sd)
                    w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, raw, own, bits, b,
                                                          encode=enc, pack=pack, seed=sd)
                    record("codec_sra_epilogue", f"{lab} ws={q.batch_rows} own={own} words", w, pw,
                           quiet=True)
                    record("codec_sra_epilogue", f"{lab} ws={q.batch_rows} own={own} meta", m, pm,
                           quiet=True)
                checked += 5
            del xs, rows, q1, q8
    log(f"  {'stochastic B1/B3':21s} {checked} calls at bits 1-8, buckets 128-16384 (ws 1 and 8, "
        f"raw row or not; 4 lowerings) bit-identical")

    # Every cluster size forced, tiles of one and two chunks, ring depths
    # 1-8 (B7a, B7c), positions in rounds (B = 1760, 16384).
    tried = 0
    for b, ch in SR_FORCED:
        n = ch * 32 * b
        rows = torch.from_numpy(np.stack([fuzz_operand(rng, n, 0) for _ in range(SRA_WS)])).to(dev)
        q = codec_cuda.quantize_batch(rows, BITS, b)
        w0, m0 = q.packed.contiguous(), q.meta.contiguous()
        pq = codec_cuda.quantize_chunks_plain(rows[0], BITS, b, seed=sd)
        pe = codec_cuda.sra_epilogue_chunks_plain(w0, m0, rows[1], 1, BITS, b, seed=sd)
        geoms = set(codec_cuda.cluster_geometries(b)) | {
            codec_cuda.cluster_geometry(ch, b, BITS, sms), codec_cuda.db_geometry(ch, b, BITS, sms)}
        for g in sorted(geoms, key=lambda g: (g.k, g.threads)):
            got = {"codec_quantize": codec_cuda._launch_quantize(rows[0], BITS, b, "div", "sum", g, seed=sd),
                   "codec_sra_epilogue": codec_cuda._launch_epilogue(w0, m0, rows[1], 1, BITS, b, "div",
                                                                     "sum", g, seed=sd)}
            lab = f"stochastic B={b} k={g.k} T={g.threads} rounds={g.positions}"
            for name, want in (("codec_quantize", pq), ("codec_sra_epilogue", pe)):
                record(name, lab + " words", got[name][0], want[0], quiet=True)
                record(name, lab + " meta", got[name][1], want[1], quiet=True)
            if (b // g.k) % g.threads:
                continue  # the pipelined kernels take rounds of equal width only
            for tc in sorted({1, 2 - ch % 2}):
                for slots in (1, 2, 4, 8):
                    lab2 = f"{lab} tc={tc} slots={slots}"
                    # B7a's slots hold 32 x T floats: as many as a block's shared memory takes.
                    if (codec_cuda.DB_BAR_BYTES + slots * 128 * g.threads
                            + codec_cuda.DB_CLUSTER_STATIC_BYTES <= codec_cuda.SMEM_BLOCK_BYTES):
                        dq = codec_cuda._launch_quantize_db(rows[0], BITS, b, tc, "div", "sum", g,
                                                            slots, seed=sd)
                        record("codec_quantize_db", lab2 + " words", dq[0], pq[0],
                               got["codec_quantize"][0], quiet=True)
                        record("codec_quantize_db", lab2 + " meta", dq[1], pq[1],
                               got["codec_quantize"][1], quiet=True)
                    de = codec_cuda._launch_epilogue_db(w0, m0, rows[1], 1, BITS, b, tc, "div", "sum",
                                                        g, slots, seed=sd)
                    record("codec_sra_epilogue_db", lab2 + " words", de[0], pe[0],
                           got["codec_sra_epilogue"][0], quiet=True)
                    record("codec_sra_epilogue_db", lab2 + " meta", de[1], pe[1],
                           got["codec_sra_epilogue"][1], quiet=True)
                    tried += 1
        del rows, q, w0, m0
    log(f"  {'stochastic B7a/B7c':21s} {tried} forced (geometry, tile, ring depth) launches, "
        f"bit-identical to the plain versions and to B1/B3")

    # The distribution: every level floor(q) or floor(q) + 1 on the slice;
    # over 64 seeds the mean decode error summed over 1M values within
    # 4 sigma of zero (sigma from each value's Bernoulli variance).
    w, m = codec_cuda.quantize_chunks(x, BITS, BUCKET, seed=sd)
    lvl = codec.unpack_levels_bucketed(w, BITS, flat_n // BUCKET, BUCKET).double()
    xb = x.view(-1, BUCKET).double()
    unit, bmin = m[:, 0].double(), m[:, 1].double()
    qv = ((x.view(-1, BUCKET) - m[:, 1:2]) / torch.where(m[:, 0:1] > 0, m[:, 0:1], 1.0)).double()
    d = lvl - torch.floor(qv)
    bad = int((~((d == 0) | (d == 1) | (lvl == (1 << BITS) - 1))).sum())
    if bad:
        raise AssertionError(f"stochastic levels: {bad} are neither floor(q) nor floor(q) + 1")
    nd = min(32 * BUCKET * 64, flat_n)
    xd = x[:nd]
    acc = torch.zeros(nd, dtype=torch.float64, device=dev)
    for s in range(64):
        ws_, ms_ = codec_cuda.quantize_chunks(xd, BITS, BUCKET, seed=sd + s)
        acc += codec_cuda.dequantize_chunks(ws_, ms_, BITS, BUCKET).double()
    mq = codec_cuda.quantize_chunks(xd, BITS, BUCKET)[1].double()
    frac = qv.reshape(-1)[:nd] - torch.floor(qv.reshape(-1)[:nd])
    var = (mq[:, 0].repeat_interleave(BUCKET) ** 2) * frac * (1 - frac) / 64
    bias = float((acc / 64 - xd.double()).sum())
    sigma = float(var.sum().sqrt())
    log(f"  {'stochastic rounding':21s} levels floor(q) or floor(q)+1: all {flat_n}; mean decode over 64 "
        f"seeds, error summed over {nd} values {bias:.4e} = {bias / sigma:+.2f} sigma ({sigma:.4e}); "
        f"{time.perf_counter() - t0:.1f} s")
    if abs(bias) > 4 * sigma:
        raise AssertionError(f"stochastic rounding biased: {bias / sigma:.2f} sigma")
    del x, xb, lvl, qv, acc, unit, bmin


def check_subf32(dev, flat_n: int, tail_n: int, rng, record) -> None:
    """The 16-bit wire dtypes (``PHASE3_WIRE16``: bf16) against the plain
    versions on the card's tensors, bit for bit, at the bf16-parameter
    step's shapes: B1
    and B7a (B7a's bytes equal to B1's) on a 64 MB slice of 2-byte values
    (``2 * flat_n``) and B5 on the tail slice's 307 chunks, in every
    (encode, pack) lowering, round to nearest and stochastic; B3 and B7c
    (B7c's equal to B3's) rounding through the wire dtype at one row on the
    64 MB slice and at the four-rank flat SRA's ws 4 x a quarter of it with
    the raw own row in the wire dtype, in every lowering and both
    roundings; B4 with a 16-bit raw own row at the two-level scheme's 2 x
    half a slice, at both widths; the decode glue (``dequantize_batch``:
    the meta and a 16-bit accumulator upcast outside B2/B7b) on the tail
    slice against the batch function on the CPU, on the 64 MB slice
    against the plain version on the card. Every launch of B1, B7a, B3, B7c
    and B4 here reads its 16-bit operand itself (``WIRE16_LAUNCHES``)."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lowerings = [(e, p) for e in codec_cuda.ENCODES for p in codec_cuda.PACKS]
    chunk_n = 32 * BUCKET
    tail_chunks = tail_n // chunk_n
    for name in PHASE3_WIRE16:
        dtype = getattr(torch, name)
        t0 = time.perf_counter()
        codec_cuda.reset_launch_counts()
        for n in (2 * flat_n, tail_chunks * chunk_n):
            x = torch.from_numpy(fuzz_operand(rng, n, 0)).to(dtype).to(dev)
            chunks = n // chunk_n
            tc = codec_cuda._pipe_tc(chunks, codec_cuda.db_tc_cap(
                "quantize", BITS, BUCKET, chunks=chunks, sms=sms, elem_size=2))
            for enc in codec_cuda.ENCODES:
                for seed in (None, SR_SEED):
                    pw, pm = codec_cuda.quantize_chunks_plain(x, BITS, BUCKET, encode=enc, seed=seed)
                    for pack in codec_cuda.PACKS:
                        lab = f"{name} c={chunks} {enc}/{pack} {'stoch.' if seed else 'nearest'}"
                        w, m = codec_cuda.quantize_chunks(x, BITS, BUCKET, encode=enc, pack=pack, seed=seed)
                        record("codec_quantize", lab + " words", w, pw, quiet=True)
                        record("codec_quantize", lab + " meta", m, pm, quiet=True)
                        dw, dm = codec_cuda.quantize_chunks_db(x, BITS, BUCKET, tc, encode=enc,
                                                               pack=pack, seed=seed)
                        record("codec_quantize_db", f"{lab} tc={tc} words", dw, pw, w, quiet=True)
                        record("codec_quantize_db", f"{lab} tc={tc} meta", dm, pm, m, quiet=True)
            log(f"  {'codec_quantize(_db)':21s} {name} at {chunks} chunks: B1 and B7a (tc={tc}) "
                f"bit-identical to the plain version in 4 lowerings x 2 roundings, B7a = B1")
            del x
        # The epilogue at one row (the world-size-1 proxy) on the 64 MB
        # slice, and at ws 4 of its quarter with the raw own row.
        for ws, n, owns in ((1, 2 * flat_n, [None]), (SRA_WS, 2 * flat_n // SRA_WS, [0, SRA_WS - 1])):
            rows = torch.from_numpy(
                np.stack([fuzz_operand(rng, n, 0) * np.float32(r + 1) for r in range(ws)])
            ).to(dtype).to(dev)
            q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
            meta = q.meta.float()
            chunks = n // chunk_n
            tc = codec_cuda._pipe_tc(chunks, codec_cuda.db_tc_cap(
                "epilogue", BITS, BUCKET, chunks=chunks, sms=sms))
            for own in owns:
                raw, o = (None, -1) if own is None else (rows[own], own)
                for enc in codec_cuda.ENCODES:
                    for seed in (None, SR_SEED):
                        pw, pm = codec_cuda.sra_epilogue_chunks_plain(
                            q.packed, meta, raw, o, BITS, BUCKET, dtype, enc, seed=seed)
                        for pack in codec_cuda.PACKS:
                            kw = dict(cast_dtype=dtype, encode=enc, pack=pack, seed=seed)
                            lab = (f"{name} ws={ws} own={own} c={chunks} {enc}/{pack} "
                                   f"{'stoch.' if seed else 'nearest'}")
                            w, m = codec_cuda.sra_epilogue_chunks(q.packed, meta, raw, o, BITS, BUCKET,
                                                                  **kw)
                            record("codec_sra_epilogue", lab + " words", w, pw, quiet=True)
                            record("codec_sra_epilogue", lab + " meta", m, pm, quiet=True)
                            dw, dm = codec_cuda.sra_epilogue_chunks_db(q.packed, meta, raw, o, BITS,
                                                                       BUCKET, tc, **kw)
                            record("codec_sra_epilogue_db", f"{lab} tc={tc} words", dw, pw, w, quiet=True)
                            record("codec_sra_epilogue_db", f"{lab} tc={tc} meta", dm, pm, m, quiet=True)
            log(f"  {'codec_sra_epilogue(_db)':21s} {name} ws={ws} owns={owns} at {chunks} chunks: "
                f"B3 and B7c (tc={tc}) bit-identical to the plain version in 4 lowerings x 2 "
                f"roundings, B7c = B3")
            del rows, q, meta
        # B4: the two-level scheme's intra reduce of the 64 MB slice (2 rows
        # of half of it, the raw own row in each position), both widths.
        rows = torch.from_numpy(
            np.stack([fuzz_operand(rng, flat_n, 0) * np.float32(r + 1) for r in range(2)])
        ).to(dtype).to(dev)
        q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
        meta = q.meta.float()
        for own in (0, 1):
            want = codec_cuda.reduce_rows_chunks_plain(q.packed, meta, rows[own], own, BITS, BUCKET)
            got = codec_cuda.reduce_rows_chunks(q.packed, meta, rows[own], own, BITS, BUCKET)
            scalar = codec_cuda._launch_reduce(q.packed, meta, rows[own], own, BITS, BUCKET,
                                               torch.empty_like(want), 1)
            record("codec_reduce_rows", f"{name} two-level rows=2 own={own} c={flat_n // chunk_n}",
                   got, want)
            record("codec_reduce_rows", f"{name} two-level rows=2 own={own} scalar width", scalar, want)
        del rows, q, meta
        wire = dict(codec_cuda.WIRE16_LAUNCHES)
        launched = {k: codec_cuda.LAUNCHES[k] for k in wire}
        log(f"  {name}: launches reading a 16-bit operand {wire} of {launched} "
            f"({time.perf_counter() - t0:.1f} s)")
        assert wire == launched, (wire, launched)
        # The decode glue: sub-f32 meta and accumulator upcast outside the
        # decode kernels, the output cast to the accumulator's dtype; under
        # CGX_PALLAS_DB=on the pipelined decode (B7b).
        for n in (tail_n, 2 * flat_n):
            x = torch.from_numpy(fuzz_operand(rng, n, 0)).to(dtype)
            acc = torch.from_numpy(fuzz_operand(rng, n, 0)).to(dtype)
            q = codec_cuda.quantize_batch(x.to(dev)[None], BITS, BUCKET)
            for mode, kernel in (("off", "codec_dequantize"), ("on", "codec_dequantize_db")):
                os.environ["CGX_PALLAS_DB"] = mode
                codec_cuda.reset_launch_counts()
                got = codec_cuda.dequantize_batch(q, add_to=acc.to(dev)[None])[0]
                sync(dev)
                if n == tail_n:
                    want = codec_cuda.dequantize_batch(
                        codec_cuda.quantize_batch(x[None], BITS, BUCKET), add_to=acc[None])[0]
                else:
                    want = codec_cuda.dequantize_chunks_plain(
                        q.packed[0], q.meta[0], BITS, BUCKET, add_to=acc.to(dev)).to(dtype)
                k = kernel if codec_cuda.LAUNCHES[kernel] else "codec_dequantize"
                record(k, f"{name} n={n} add_to {name}, CGX_PALLAS_DB={mode}", got.cpu(), want.cpu())
            os.environ["CGX_PALLAS_DB"] = "off"
            del x, acc, q


def check_reduce(dev, rng, record) -> None:
    """The multi-row reduce (B4) against its plain version run on the card's
    tensors, bit for bit, at full width and forced to scalar width: at each
    launch shape of phase 7's four-rank steps (``shapebench.REDUCE_SHAPES``),
    then at every templated row count (1-8) and one above (11), with the
    raw own row in every position and none; a raw row view that is not
    16-byte aligned takes the scalar width (``codec_cuda.REDUCE_SCALAR``)."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.tools import shapebench

    def both(label, words, meta, raw, own, b):
        want = codec_cuda.reduce_rows_chunks_plain(words, meta, raw, own, BITS, b)
        record("codec_reduce_rows", label, codec_cuda.reduce_rows_chunks(words, meta, raw, own, BITS, b),
               want, quiet=True)
        out = torch.empty_like(want)
        record("codec_reduce_rows", label + " scalar width",
               codec_cuda._launch_reduce(words, meta, raw, own, BITS, b, out, 1), want, quiet=True)

    cases = [(c, rows, [None, 0, 1] if own >= 0 else [None, rows - 1])
             for _, _, c, rows, own in shapebench.REDUCE_SHAPES]
    cases += [(3, rows, [None] + list(range(rows))) for rows in (1, 2, 3, 4, 5, 6, 7, 8, 11)]
    for chunks, rows_n, owns in cases:
        n = chunks * 32 * BUCKET
        rows = torch.from_numpy(
            np.stack([fuzz_operand(rng, n, 0) * np.float32(r + 1) for r in range(rows_n)])).to(dev)
        q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
        w, m = q.packed.contiguous(), q.meta.contiguous()
        for own in owns:
            raw, o = (None, -1) if own is None else (rows[own], own)
            both(f"rows={rows_n} chunks={chunks} own={own}", w, m, raw, o, BUCKET)
        log(f"  {'codec_reduce_rows':21s} rows={rows_n} chunks={chunks}, owns {owns}: "
            f"bit-identical at full and at scalar width")
        del rows, q, w, m
    n = 3 * 32 * BUCKET
    rows = torch.from_numpy(np.stack([fuzz_operand(rng, n, k) for k in range(3)])).to(dev)
    q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
    buf = torch.empty(n + 1, device=dev)
    buf[1:] = rows[1]
    codec_cuda.reset_launch_counts()
    got = codec_cuda.reduce_rows_chunks(q.packed, q.meta, buf[1:], 1, BITS, BUCKET)
    record("codec_reduce_rows", "raw row 4 bytes past a 16-byte boundary", got,
           codec_cuda.reduce_rows_chunks_plain(q.packed, q.meta, rows[1], 1, BITS, BUCKET))
    if codec_cuda.REDUCE_SCALAR["launches"] != 1:
        raise AssertionError("an unaligned raw row did not take the scalar width")


def check_cluster(dev, rng, record) -> None:
    """The cluster kernels (B1/B5 and B3) against their plain versions run on
    the card's tensors, bit for bit: at each launch shape of the step
    (``shapebench.SHAPES``) in every (encode, pack) lowering; at every width
    and at buckets whose geometry takes 1 to 8 CTAs a chunk (8 x 512
    threads at 4096) or positions in rounds past the register budget (1760,
    16384), on normal and ``qbench.adversarial_operand`` data; B3 at ws 1
    and 4, with and without the raw row, row 0 adversarial. Then the
    reciprocal quotient of the div encode against the IEEE divide
    (``codec_cuda.reciprocal_sweep``): every divisor significand at
    exponent 0, every 64th at the edges of its range: not one level and not
    one quotient different."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.tools import qbench, shapebench

    lowerings = [(e, p) for e in codec_cuda.ENCODES for p in codec_cuda.PACKS]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def epilogue(q, raw, own, bits, b, label, quiet=False):
        for enc, pack in lowerings:
            w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, raw, own, bits, b,
                                                  encode=enc, pack=pack)
            pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, raw, own, bits, b,
                                                          encode=enc)
            record("codec_sra_epilogue", f"{label} {enc}/{pack} words", w, pw, quiet=quiet)
            record("codec_sra_epilogue", f"{label} {enc}/{pack} meta", m, pm, quiet=quiet)

    for kernel, label, chunks, rows_n, own in shapebench.SHAPES:
        n = chunks * 32 * BUCKET
        g = codec_cuda.cluster_geometry(chunks, BUCKET, BITS, sms)
        label = f"{label} (k={g.k}, {g.threads} threads)"
        rows = torch.from_numpy(
            np.stack([fuzz_operand(rng, n, 0) * np.float32(r + 1) for r in range(rows_n)])).to(dev)
        raw = rows[own] if own >= 0 else None
        if kernel == "quantize":
            for enc, pack in lowerings:
                w, m = codec_cuda.quantize_chunks(rows[0], BITS, BUCKET, encode=enc, pack=pack)
                pw, pm = codec_cuda.quantize_chunks_plain(rows[0], BITS, BUCKET, encode=enc)
                record("codec_quantize", f"{label} {enc}/{pack} words", w, pw)
                record("codec_quantize", f"{label} {enc}/{pack} meta", m, pm)
        elif kernel == "epilogue":
            q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
            epilogue(q, raw, own, BITS, BUCKET, label)
        else:
            check_db_cluster(dev, kernel, rows, raw, own, chunks, label, lowerings, record)
        del rows
    for bits in range(1, 9):
        checked = 0
        for b in (128, 512, 896, 1760, 1792, 4096, 16384):
            n = 3 * 32 * b
            for name, x in (("normal", fuzz_operand(rng, n, 0)),
                            ("adversarial", qbench.adversarial_operand(n, b, bits, seed=bits))):
                x = torch.from_numpy(x).to(dev)
                for enc, pack in lowerings:
                    w, m = codec_cuda.quantize_chunks(x, bits, b, encode=enc, pack=pack)
                    pw, pm = codec_cuda.quantize_chunks_plain(x, bits, b, encode=enc)
                    label = f"c=3 bits={bits} B={b} {name} {enc}/{pack}"
                    record("codec_quantize", label + " words", w, pw, quiet=True)
                    record("codec_quantize", label + " meta", m, pm, quiet=True)
                    checked += 1
                if name == "adversarial":
                    for ws, own in ((1, -1), (1, 0), (4, -1), (4, 2)):
                        rows = torch.stack([x] + [torch.from_numpy(fuzz_operand(rng, n, 0)).to(dev)
                                                  for _ in range(ws - 1)])
                        q = codec_cuda.quantize_batch(rows, bits, b)
                        epilogue(q, rows[own] if own >= 0 else None, own, bits, b,
                                 f"c=3 bits={bits} B={b} {name} ws={ws} own={own}", quiet=True)
                        checked += 4
        log(f"  {'codec_quantize/epilogue':21s} bits={bits}: {checked} calls at buckets 128-16384 "
            f"(normal, adversarial; ws 1 and 4, raw row or not; 4 lowerings) bit-identical")
    t0 = time.perf_counter()
    sweeps = [(0, 1, 64)] + [(e2, 64, 16) for e2 in (-64, -63, 62, 63, -65, 64)]
    for e2, step, extra in sweeps:
        r = codec_cuda.reciprocal_sweep(dev, e2=e2, m_step=step, extra=extra)
        log(f"  {'reciprocal quotient':21s} 2^{e2} x every {step} of 2^23 significands: "
            f"{r['pairs']} pairs, {r['quotients_differ']} quotients and {r['levels_differ']} "
            f"8-bit levels differ from __fdiv_rn" + (f"; first {r['first']}" if r["first"] else ""))
        if r["quotients_differ"] or r["levels_differ"]:
            raise AssertionError(f"the reciprocal quotient differs from the IEEE divide at 2^{e2}")
    log(f"  the sweep took {time.perf_counter() - t0:.1f} s")


def check_db_cluster(dev, kernel, rows, raw, own, chunks, label, lowerings, record) -> None:
    """B7a ("quantize_db": of ``rows[0]``) or B7c ("epilogue_db": of the
    rows' payload, ``raw`` in place of row ``own``) at one launch shape of
    the step: at the wrappers' geometry in every (encode, pack) lowering,
    then at every cluster size the bucket takes, forced, at tiles of one
    and two chunks; bit for bit against the plain version on the card's
    tensors."""
    from torch_cgx_tpu_torch.ops import codec_cuda

    if kernel == "quantize_db":
        name = "codec_quantize_db"
        plain = lambda enc: codec_cuda.quantize_chunks_plain(rows[0], BITS, BUCKET, encode=enc)  # noqa: E731
        run = lambda enc, pack: codec_cuda.quantize_chunks_db(rows[0], BITS, BUCKET, 1, encode=enc,  # noqa: E731
                                                              pack=pack)
        forced = lambda g, tc: codec_cuda._launch_quantize_db(rows[0], BITS, BUCKET, tc, "div", "sum", g)  # noqa: E731
    else:
        name = "codec_sra_epilogue_db"
        q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
        w0, m0 = q.packed.contiguous(), q.meta.contiguous()
        plain = lambda enc: codec_cuda.sra_epilogue_chunks_plain(w0, m0, raw, own, BITS, BUCKET,  # noqa: E731
                                                                 encode=enc)
        run = lambda enc, pack: codec_cuda.sra_epilogue_chunks_db(w0, m0, raw, own, BITS, BUCKET, 1,  # noqa: E731
                                                                  encode=enc, pack=pack)
        forced = lambda g, tc: codec_cuda._launch_epilogue_db(w0, m0, raw, own, BITS, BUCKET, tc,  # noqa: E731
                                                              "div", "sum", g)
    for enc, pack in lowerings:
        pw, pm = plain(enc)
        w, m = run(enc, pack)
        record(name, f"{label} tc=1 {enc}/{pack} words", w, pw)
        record(name, f"{label} tc=1 {enc}/{pack} meta", m, pm)
    pw, pm = plain("div")
    tried = []
    for g in codec_cuda.cluster_geometries(BUCKET):
        for tc in sorted({1, 2 - chunks % 2}):
            w, m = forced(g, tc)
            record(name, f"{label} k={g.k} tc={tc} words", w, pw, quiet=True)
            record(name, f"{label} k={g.k} tc={tc} meta", m, pm, quiet=True)
            tried.append(f"k={g.k} tc={tc}")
    log(f"  {name:21s} {label}: {', '.join(tried)} bit-identical")


def check_b9(dev, flat_n: int, record) -> None:
    """B9's three bodies against their plain versions on the card (run on
    the card's tensors): at B1's own geometry for the slice, the DB_CHUNKS
    sizes and the 144 chunks of phase 6's ``--mb 9``, and at each cluster
    geometry of the bucket forced, on normal and adversarial data."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.tools import qbench

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for n in [flat_n] + [c * 32 * BUCKET for c in DB_CHUNKS + (QBENCH_STEP_CHUNKS,)]:
        x = torch.randn(n, generator=gen, device=dev) * 40
        g = codec_cuda._geometry(x, n // (32 * BUCKET), BUCKET, BITS)
        for bits in (1, 2, 4, 8):
            for variant in codec_cuda.VARIANTS:
                w, m = codec_cuda.quantize_variant_chunks(x, variant, bits, BUCKET)
                pw, pm = codec_cuda.quantize_variant_chunks_plain(x, variant, bits, BUCKET)
                label = f"{variant} n={n} bits={bits} k={g.k}"
                record("codec_quantize_variant", label + " words", w, pw)
                record("codec_quantize_variant", label + " meta", m, pm)
        del x
    n = DB_CHUNKS[1] * 32 * BUCKET
    operands = (("normal", torch.randn(n, generator=gen, device=dev) * 40),
                ("adversarial", torch.from_numpy(
                    qbench.adversarial_operand(n, BUCKET, BITS, seed=SEED)).to(dev)))
    for kind, x in operands:
        tried = []
        for g in codec_cuda.cluster_geometries(BUCKET):
            for variant in codec_cuda.VARIANTS:
                w, m = codec_cuda.quantize_variant_chunks(x, variant, BITS, BUCKET, g)
                pw, pm = codec_cuda.quantize_variant_chunks_plain(x, variant, BITS, BUCKET)
                label = f"{variant} {kind} n={n} k={g.k}"
                record("codec_quantize_variant", label + " words", w, pw, quiet=True)
                record("codec_quantize_variant", label + " meta", m, pm, quiet=True)
            tried.append(f"k={g.k} x {g.threads}")
        log(f"  {'codec_quantize_variant':21s} {kind} n={n}, each variant forced to "
            f"{', '.join(tried)}: bit-identical")


def check_lowerings(dev, flat_n: int, ws: int, rng, record, db_tc) -> None:
    """Every quantizing kernel in each (encode, pack) lowering against the
    plain version of that encode on the same inputs: B1 and B7a on the 64 MB
    slice of normal data and of ``qbench.tie_operand``'s ties, B3 and B7c at
    ws rows (the raw own row a tie row), B8 on integer operands. The
    butterfly pack's bytes must equal the sum pack's, and on the ties the
    mul encode's levels must differ from the div encode's, by one level at
    most: the knob reached the kernel."""
    import torch

    from torch_cgx_tpu_torch.ops import codec, codec_cuda
    from torch_cgx_tpu_torch.tools import qbench

    lowerings = [(e, p) for e in codec_cuda.ENCODES for p in codec_cuda.PACKS]
    chunks = flat_n // (32 * BUCKET)
    tc = db_tc("codec_quantize", chunks, BITS, BUCKET)
    operands = {
        "normal": torch.from_numpy(fuzz_operand(rng, flat_n, 0)).to(dev),
        "ties": torch.from_numpy(qbench.tie_operand(flat_n, BUCKET, BITS, seed=SEED)).to(dev),
    }
    for name, x in operands.items():
        got = {}
        for enc, pack in lowerings:
            label = f"{name} n={flat_n} {enc}/{pack}"
            pw, pm = codec_cuda.quantize_chunks_plain(x, BITS, BUCKET, encode=enc)
            w, m = codec_cuda.quantize_chunks(x, BITS, BUCKET, encode=enc, pack=pack)
            record("codec_quantize", label + " words", w, pw)
            record("codec_quantize", label + " meta", m, pm)
            dw, dm = codec_cuda.quantize_chunks_db(x, BITS, BUCKET, tc, encode=enc, pack=pack)
            record("codec_quantize_db", f"{label} tc={tc} words", dw, pw, w)
            record("codec_quantize_db", f"{label} tc={tc} meta", dm, pm, m)
            got[enc, pack] = w
        for enc in codec_cuda.ENCODES:
            if not _same_bits(got[enc, "butterfly"], got[enc, "sum"]):
                raise AssertionError(f"{name} {enc}: the butterfly pack's bytes differ from the sum pack's")
        lv = {e: codec.unpack_levels_bucketed(got[e, "sum"], BITS, flat_n // BUCKET, BUCKET)
              for e in codec_cuda.ENCODES}
        diff = (lv["mul"] - lv["div"]).abs()
        moved, most = int((diff > 0).sum()), int(diff.max())
        log(f"  {'codec_quantize':21s} {name + ': levels mul vs div':44s} {moved} of {flat_n} differ, "
            f"by at most {most}; butterfly bytes = sum bytes")
        if name == "ties" and not (moved > 0 and most == 1):
            raise AssertionError(f"the mul encode did not reach the kernel ({moved} levels moved, most {most})")
        if most > 1:
            raise AssertionError(f"{name}: mul and div levels differ by {most}")
    del operands

    chunk = flat_n // ws
    rows = np.stack([fuzz_operand(rng, chunk, 0) * (r + 1) for r in range(ws)])
    own = 1
    rows[own] = qbench.tie_operand(chunk, BUCKET, BITS, seed=SEED + 1)
    rows = torch.from_numpy(rows).to(dev)
    q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
    te = db_tc("codec_sra_epilogue", chunk // (32 * BUCKET), BITS, BUCKET)
    for enc in codec_cuda.ENCODES:
        pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, rows[own], own, BITS, BUCKET,
                                                      encode=enc)
        for pack in codec_cuda.PACKS:
            label = f"ws={ws} own={own} n={chunk} {enc}/{pack}"
            w, m = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, rows[own], own, BITS, BUCKET,
                                                  encode=enc, pack=pack)
            record("codec_sra_epilogue", label + " words", w, pw)
            record("codec_sra_epilogue", label + " meta", m, pm)
            dw, dm = codec_cuda.sra_epilogue_chunks_db(q.packed, q.meta, rows[own], own, BITS, BUCKET,
                                                       te, encode=enc, pack=pack)
            record("codec_sra_epilogue_db", f"{label} tc={te} words", dw, pw, w)
            record("codec_sra_epilogue_db", f"{label} tc={te} meta", dm, pm, m)
    del rows, q

    for layer, (din, o) in MM_SHAPES.items():
        xi = torch.from_numpy(rng.integers(-3, 4, (MM_K, din)).astype(np.float32)).to(dev)
        gi = torch.from_numpy(rng.integers(-3, 4, (MM_K, o)).astype(np.float32)).to(dev)
        for enc in codec_cuda.ENCODES:
            pw, pm = codec_cuda.matmul_quantize_chunks_plain(xi, gi, MR_WS, BITS, BUCKET, encode=enc)
            for pack in codec_cuda.PACKS:
                label = f"{layer} K={MM_K} {din}x{o} integer {enc}/{pack}"
                w, m = codec_cuda.matmul_quantize_chunks(xi, gi, MR_WS, BITS, BUCKET, encode=enc, pack=pack)
                record("codec_matmul_quantize", label + " words", w, pw)
                record("codec_matmul_quantize", label + " meta", m, pm)


# ---------------------------------------------------------------------------
# Phase 4: the GPT-2 slice.
# ---------------------------------------------------------------------------


class LaunchModel:
    """Kernel launches one compressed gradient sync makes on one rank,
    derived from the gradient layout and decided by the dispatcher's own
    gates (``codec_cuda.supports``, ``dispatch.fused_epilogue_would_run``,
    ``dispatch.fused_reduce_would_run``, ``dispatch.db_would_run``) on
    layout-only stand-ins for each payload: each method mirrors one reducer
    of ``parallel/reducers.py``. A quantize, decode or epilogue counts as
    its pipelined kernel where ``db_would_run`` says the batch function
    takes it (``CGX_PALLAS_DB`` and the autotune cache as they stand;
    ``stochastic``: a stochastic epilogue, which makes no lookup). ``dtype``:
    the payloads' tensor dtype (a caller sets it group by group), whose
    element size B7a's ring takes."""

    def __init__(self, dev, stochastic: bool = False, dtype=None):
        import torch

        self.dev = dev
        self.stochastic = stochastic
        self.dtype = dtype or torch.float32
        self.counts = {k: 0 for k in TPU_KERNELS}

    def _stand_in(self, rows: int, n: int, cc):
        import torch

        from torch_cgx_tpu_torch.ops import codec

        nb = codec.num_buckets(n, cc.bucket_size)
        return codec.QTensor(
            packed=torch.empty((rows, 0), dtype=torch.int32, device=self.dev),
            meta=torch.empty((rows, nb, 2), dtype=self.dtype, device=self.dev),
            residual=torch.empty((rows, 0), dtype=self.dtype, device=self.dev),
            numel=n, bits=cc.bits, bucket_size=cc.bucket_size, dtype=self.dtype,
        )

    def _launch(self, kernel: str, rows: int, n: int, cc, add: bool = False) -> None:
        from torch_cgx_tpu_torch.ops import dispatch

        db = dispatch.db_would_run(self._stand_in(rows, n, cc), DB_OF[kernel], with_add=add,
                                   stochastic=self.stochastic)
        self.counts[kernel + "_db" if db else kernel] += 1

    def codec(self, kernel: str, n: int, cc, rows: int = 1, add: bool = False) -> None:
        """A quantize or decode (``add``: with an accumulator) of ``rows``
        rows of ``n`` values: one launch when the chunk kernels cover the
        rows and they hold a whole chunk."""
        from torch_cgx_tpu_torch.ops import codec, codec_cuda

        b = cc.bucket_size
        if codec_cuda.supports(n, cc.bits, b, False) and codec.num_buckets(n, b) >= codec.CHUNK_BUCKETS:
            self._launch(kernel, rows, n, cc, add)

    def reduce(self, rows: int, n: int, cc) -> None:
        """``dispatch.reduce_rows`` without an accumulator."""
        from torch_cgx_tpu_torch.ops import dispatch

        if dispatch.fused_reduce_would_run(self._stand_in(rows, n, cc)):
            self.counts["codec_reduce_rows"] += 1
        else:
            self.codec("codec_dequantize", n, cc, rows)

    def epilogue(self, rows: int, n: int, cc) -> bool:
        """``dispatch.reduce_rows_requantize``'s fused kernel, if it runs."""
        from torch_cgx_tpu_torch.ops import dispatch

        if not dispatch.fused_epilogue_would_run(self._stand_in(rows, n, cc)):
            return False
        self._launch("codec_sra_epilogue", rows, n, cc)
        return True

    def proxy(self, m: int, cc) -> None:
        """The world-size-1 ``CGX_DEBUG_FORCE_CODEC`` proxy."""
        self.codec("codec_quantize", m, cc)
        if self.epilogue(1, m, cc):
            self.codec("codec_dequantize", m, cc)
        else:
            self.codec("codec_dequantize", m, cc)
            self.codec("codec_dequantize", m, cc, add=True)

    def sra(self, m: int, ws: int, cc, produced=None, chunks=None) -> None:
        """``produced``: the dtype of the operands of the backward's
        matmul-quantize that made the stage-1 payload, in place of the
        quantize (float32 operands run the split pass before it), or
        None. ``chunks``: the step planner's depth for the slice (None: the
        schedule's knobs)."""
        import torch

        from torch_cgx_tpu_torch.parallel import chunk_layout

        sched = self._schedule(m, ws, cc, chunks)
        if sched is not None:
            # The pipelined SRA: each column block quantized (under producer
            # fusion by the backward, from dw, with the same B1), folded and
            # requantized, gathered and decoded.
            for _, w in sched.table:
                self.codec("codec_quantize", w, cc, ws)
                if not self.epilogue(ws, w, cc):
                    self.reduce(ws, w, cc)
                    self.codec("codec_quantize", w, cc)
                self.codec("codec_dequantize", w, cc, ws)
            return
        c = chunk_layout(m, ws)[0]
        if produced is not None:
            self.counts["codec_matmul_quantize"] += 1
            self.counts["codec_tf32_split"] += produced == torch.float32
        else:
            self.codec("codec_quantize", c, cc, ws)
        if not self.epilogue(ws, c, cc):
            self.reduce(ws, c, cc)
            self.codec("codec_quantize", c, cc)
        self.codec("codec_dequantize", c, cc, ws)

    def _schedule(self, m: int, ws: int, cc, chunks=None):
        """``allreduce_flat``'s pipeline plan of a flat SRA slice of ``m``
        values (None: monolithic), at the planner's depth ``chunks`` where
        it plans the slice."""
        from torch_cgx_tpu_torch.parallel import schedule

        return schedule.compiled_schedule(m, ws, cc, chunks=chunks)

    def ring(self, m: int, ws: int, cc) -> None:
        from torch_cgx_tpu_torch.parallel import chunk_layout

        seg = chunk_layout(m, ws)[0]
        for _ in range(ws - 1):  # scatter-reduce hops: requantize, decode-add
            self.codec("codec_quantize", seg, cc)
            self.codec("codec_dequantize", seg, cc, add=True)
        self.codec("codec_quantize", seg, cc)  # the owned segment, once
        for _ in range(ws):  # its own decode and ws-1 all-gather hops
            self.codec("codec_dequantize", seg, cc)

    def alltoall(self, m: int, ws: int, cc) -> None:
        self.codec("codec_quantize", m, cc)
        self.reduce(ws, m, cc)

    def flat(self, m: int, ws: int, cc, reduction: str, chunks=None) -> None:
        """``reducers.quantized_allreduce`` (``chunks``: the planner's depth
        of an SRA slice)."""
        from torch_cgx_tpu_torch import config as cfg

        if ws == 1:
            if cc.enabled and cfg.force_codec():
                self.proxy(m, cc)
        elif cc.enabled and not cfg.dummy_compression() and reduction != cfg.REDUCTION_PSUM:
            if reduction == cfg.REDUCTION_SRA:
                return self.sra(m, ws, cc, chunks=chunks)
            {cfg.REDUCTION_RING: self.ring, cfg.REDUCTION_ALLTOALL: self.alltoall}[reduction](m, ws, cc)

    def hook(self, layers, ws: int, me: int, reduction: str, hosts=None) -> None:
        """``torch_backend.backend.allreduce`` of one DDP bucket on rank
        ``me`` of ``ws``: ``layers`` its ``(offset, numel, config)``
        (``backend._extract_layers``), ``hosts`` the group's host keys
        (``backend._hosts(group).hosts``; None: one host). Raw layers launch
        nothing; the compressed ones go segment by segment, each segment its
        own rows, through the flat reduction or, on a MIXED host map, the
        two-level scheme (:meth:`hook_hier`)."""
        from torch_cgx_tpu_torch import config as cfg
        from torch_cgx_tpu_torch.torch_backend import backend

        comp, _ = backend.split_layers(layers)
        if ws == 1 or not comp or cfg.dummy_compression():
            return
        fl, total = [], 0
        for _, n, c in comp:
            fl.append((total, n, c))
            total += n
        topo = cfg.topology_from_env()
        if hosts is not None and topo.intra_broadcast and (
            backend._host_topology(hosts) == backend.TOPO_MIXED
        ):
            self.hook_hier(fl, total, hosts, me, topo)
        else:
            self.hook_flat(fl, total, ws, me, reduction)

    def _each(self, segs, *kernels, add=False) -> None:
        from torch_cgx_tpu_torch.config import CompressionConfig

        for s in segs:
            cc = CompressionConfig(bits=s.bits, bucket_size=s.bucket_size)
            for k in kernels:
                self.codec(k, s.numel, cc, add=add)

    def hook_flat(self, fl, total: int, ws: int, me: int, reduction: str) -> None:
        """``backend._qreduce_flat`` of the fused layers ``fl``."""
        from torch_cgx_tpu_torch import config as cfg
        from torch_cgx_tpu_torch.config import CompressionConfig
        from torch_cgx_tpu_torch.torch_backend import backend

        each = self._each
        if reduction == cfg.REDUCTION_ALLTOALL:
            for s in backend._segments_in(fl, 0, total):
                cc = CompressionConfig(bits=s.bits, bucket_size=s.bucket_size)
                self.codec("codec_quantize", s.numel, cc)
                self.reduce(ws, s.numel, cc)
            return
        sizes, offs = backend._chunk_split(total, ws, fl)
        segs = [backend._segments_in(fl, offs[r], offs[r] + sizes[r]) for r in range(ws)]
        if reduction == cfg.REDUCTION_RING:
            for step in range(ws - 1):
                each(segs[(me - step) % ws], "codec_quantize")
                each(segs[(me - step - 1) % ws], "codec_dequantize", add=True)
            each(segs[(me + 1) % ws], "codec_quantize", "codec_dequantize")
            for step in range(ws - 1):
                each(segs[(me - step) % ws], "codec_dequantize")
            return
        tables = backend._sched_tables(sizes, fl) if ws > 1 and backend._pipelines() else None
        if tables is not None:  # the pipelined SRA: the same, sub-chunk by sub-chunk
            segs = [[backend._segments_in(fl, offs[r] + o, offs[r] + o + w) for o, w in tables[r]]
                    for r in range(ws)]
        else:
            segs = [[sg] for sg in segs]
        for c in range(len(segs[0])):
            for j in range(ws):  # stage 1: every peer's chunk
                if j != me:
                    each(segs[j][c], "codec_quantize")
            for s in segs[me][c]:  # the fold and requantize, then the self-decode
                cc = CompressionConfig(bits=s.bits, bucket_size=s.bucket_size)
                if not self.epilogue(ws, s.numel, cc):
                    self.reduce(ws, s.numel, cc)
                    self.codec("codec_quantize", s.numel, cc)
                self.codec("codec_dequantize", s.numel, cc)
            for j in range(ws):  # stage 2: every peer's reduced chunk
                if j != me:
                    each(segs[j][c], "codec_dequantize")

    def hook_hier(self, fl, total: int, hosts, me: int, topo) -> None:
        """``backend._qreduce_hier``: a non-leader quantizes its whole
        buffer and decodes its leader's frame; a leader decode-adds each
        local's frame, runs the leaders' flat reduction and requantizes and
        decodes the result (under ``CGX_INTRA_COMPRESS=0`` the intra frames
        are raw and launch nothing)."""
        from torch_cgx_tpu_torch.torch_backend import backend

        segs = backend._segments_in(fl, 0, total)
        local = [r for r, h in enumerate(hosts) if h == hosts[me]]
        leaders = backend._slice_leaders(hosts)
        intra = topo.intra_compress
        if me != local[0]:
            if intra:
                self._each(segs, "codec_quantize")
                self._each(segs, "codec_dequantize")
            return
        if intra:
            for _ in local[1:]:
                self._each(segs, "codec_dequantize", add=True)
        if topo.cross_compress:
            self.hook_flat(fl, total, len(leaders), leaders.index(me), topo.cross_reduction)
        if intra:
            self._each(segs, "codec_quantize", "codec_dequantize")

    def roundtrip(self, m: int, ws: int, cc, reduction: str, mirror: bool = False,
                  chunks=None) -> None:
        """What ``return_roundtrip`` adds to a flat reduction of ``m`` values
        (error feedback): SRA and the all-to-all decode the rows they sent
        (one B2 of ws rows, of one row); the Ring quantizes and decodes its
        hop-0 segment again. ``mirror``: the two-level scheme's mirror of a
        level's stage 1 (``allreduce._roundtrip_wire_1axis``), which also
        quantizes the rows again (one B1). Exact wires add nothing."""
        from torch_cgx_tpu_torch import config as cfg
        from torch_cgx_tpu_torch.parallel import chunk_layout

        if ws == 1 or not cc.enabled or cfg.dummy_compression() or reduction == cfg.REDUCTION_PSUM:
            return
        sched = None if mirror or reduction != cfg.REDUCTION_SRA else self._schedule(m, ws, cc, chunks)
        if sched is not None:  # the pipelined SRA decodes each block it sent
            for _, w in sched.table:
                self.codec("codec_dequantize", w, cc, ws)
            return
        c = chunk_layout(m, ws)[0]
        if reduction == cfg.REDUCTION_RING:
            self.codec("codec_quantize", c, cc)
            self.codec("codec_dequantize", c, cc)
            return
        rows, n = (1, m) if reduction == cfg.REDUCTION_ALLTOALL else (ws, c)
        if mirror:
            self.codec("codec_quantize", n, cc, rows)
        self.codec("codec_dequantize", n, cc, rows)

    def roundtrip_two_level(self, m: int, wi: int, wc: int, cc, topo) -> None:
        """``allreduce._stage1_roundtrip_piece``: the mirror of the first
        quantized stage (the leader scheme's intra reduce-scatter, an SRA
        stage 1 whatever the intra reduction; nothing when the intra level
        is uncompressed)."""
        from torch_cgx_tpu_torch import config as cfg
        from torch_cgx_tpu_torch.config import CompressionConfig

        if cfg.dummy_compression() or (wi == 1 and wc == 1):
            return
        intra_cc = cc if topo.intra_compress else CompressionConfig(bits=32)
        cross_cc = cc if topo.cross_compress else CompressionConfig(bits=32)
        if wi == 1:
            return self.roundtrip(m, wc, cross_cc, topo.cross_reduction, mirror=True)
        if wc == 1 or not topo.intra_broadcast:
            return self.roundtrip(m, wi, intra_cc, topo.intra_reduction, mirror=True)
        if intra_cc.enabled:
            self.roundtrip(m, wi, intra_cc, cfg.REDUCTION_SRA, mirror=True)

    def two_level(self, m: int, wi: int, wc: int, cc, topo) -> None:
        """``reducers.hierarchical_allreduce``."""
        from torch_cgx_tpu_torch import config as cfg
        from torch_cgx_tpu_torch.config import CompressionConfig
        from torch_cgx_tpu_torch.parallel import chunk_layout

        intra_cc = cc if topo.intra_compress else CompressionConfig(bits=32)
        cross_cc = cc if topo.cross_compress else CompressionConfig(bits=32)
        if wi == 1 and wc == 1:
            return
        if wi == 1:
            return self.flat(m, wc, cross_cc, topo.cross_reduction)
        if wc == 1:
            return self.flat(m, wi, intra_cc, topo.intra_reduction)
        if not topo.intra_broadcast:
            self.flat(m, wi, intra_cc, topo.intra_reduction)
            return self.flat(m, wc, cross_cc, topo.cross_reduction)
        c = chunk_layout(m, wi)[0]
        compressed = intra_cc.enabled and not cfg.dummy_compression()
        if compressed:
            self.codec("codec_quantize", c, intra_cc, wi)
            self.reduce(wi, c, intra_cc)
        self.flat(c, wc, cross_cc, topo.cross_reduction)
        if compressed:
            self.codec("codec_quantize", c, intra_cc)
            self.codec("codec_dequantize", c, intra_cc, wi)


def expected_launches(named_grads, ws: int = 1, two_level=None, dense_k=None,
                      stochastic: bool = False, roundtrip: bool = False, dense_dtype=None) -> dict:
    """Launches of one compressed gradient sync per rank, from the layout:
    each compressed fusion slice through ``quantized_allreduce`` over a
    group of ``ws`` ranks (the env's reduction type), or through the
    two-level scheme of ``topology_from_env`` when ``two_level`` gives the
    ``(intra, cross)`` sizes. ``dense_k`` maps each dense kernel's path to
    its contraction length: with producer fusion engaged, a standalone group
    whose layer ``fused_producer.decide`` sends to the kernel gets its
    stage-1 payload from the backward's matmul-quantize, on operands of
    ``dense_dtype`` (the model's compute dtype; float32 adds the split
    pass's launch). ``stochastic``: the
    sync rounds stochastically (a key under ``CGX_STOCHASTIC_ROUNDING``).
    ``roundtrip``: the error-feedback sync, ``allreduce_tree(...,
    return_roundtrip=True)`` of the float32 ``g / ws + e`` (every group
    float32), with the round trip's launches. Each group's fusion slices
    hold 64 MB of its dtype's values. Under ``CGX_PLANNER=on`` a flat sync
    takes the step planner's plan of the layout (``planner.plan_for_layout``):
    each slice at its decision's depth and bits; a produced layer whose
    width (or, at the same width, depth) the plan moved stages its payload
    in the backward all the same (per block, B1, where the producer's own
    view of the slice pipelines) and falls back to the quantize at the
    planned width and depth."""
    import torch

    from torch_cgx_tpu_torch import config as cfg
    from torch_cgx_tpu_torch.ops import fused_producer
    from torch_cgx_tpu_torch.parallel import allreduce, planner

    model = LaunchModel(next(iter(named_grads.values())).device, stochastic)
    if roundtrip:
        named_grads = {k: v.float() for k, v in named_grads.items()}
    paths_leaves = allreduce.sorted_items(named_grads)
    groups = allreduce._tree_layout(paths_leaves, False).groups
    plan = None
    if two_level is None and planner.engaged():
        plan = planner.plan_for_layout(groups, ws, reduction=cfg.intra_reduction())
    for gi, g in enumerate(groups):
        if not g.cc.enabled:
            continue
        path, leaf = paths_leaves[g.indices[0]]
        produced = (
            two_level is None and dense_k is not None and len(g.indices) == 1
            and path in dense_k and fused_producer.engaged()
            and fused_producer.decide(path, tuple(leaf.shape), dense_k[path], ws)[0] is not None
        )
        model.dtype = g.dtype
        for si, (_, ln) in enumerate(g.slices):
            dec = plan.decisions[gi][si] if plan is not None else None
            cc = allreduce.planned_config(g.cc, dec)
            chunks = dec.chunks if dec is not None else None
            table = fused_producer._schedule_table(g.cc, ws, ln) if produced else None
            if produced and dec is not None and (
                    cc is not g.cc or table != fused_producer._schedule_table(g.cc, ws, ln, dec)):
                # Staged in the backward at the producer's own view of the
                # slice, refused by the sync (``plan``).
                if table is None:
                    model.counts["codec_matmul_quantize"] += 1
                    model.counts["codec_tf32_split"] += dense_dtype == torch.float32
                for _, w in table or ():
                    model.codec("codec_quantize", w, g.cc, ws)
                model.sra(ln, ws, cc, chunks=chunks)
            elif produced:
                model.sra(ln, ws, cc, produced=dense_dtype, chunks=chunks)
            elif two_level is None:
                model.flat(ln, ws, cc, cfg.intra_reduction(), chunks)
                if roundtrip:
                    model.roundtrip(ln, ws, cc, cfg.intra_reduction(), chunks=chunks)
            else:
                model.two_level(ln, *two_level, g.cc, cfg.topology_from_env())
                if roundtrip:
                    model.roundtrip_two_level(ln, *two_level, g.cc, cfg.topology_from_env())
    return model.counts


def gpt2_slice(dev, cfg, batch: int, seq: int, steps: int, cpu_check: bool = True) -> dict:
    """Build GPT-2 from the seed, check one gradient sync kernel-vs-plain,
    then take ``steps`` compressed train steps with the counters reset."""
    import torch

    from torch_cgx_tpu_torch.models import GPT2, lm_loss
    from torch_cgx_tpu_torch.ops import codec, codec_cuda
    from torch_cgx_tpu_torch.parallel import gradient_sync, make_train_step

    gen = torch.Generator().manual_seed(SEED)
    model = GPT2(cfg, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(batch, seq))).to(dev)
    log(f"  GPT-2: {cfg.n_layer} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{n_params} parameters; tokens {batch}x{seq}")

    # One step's gradients, synced through the kernels and through the plain
    # versions on the CPU. The CPU run forces the fused era the card takes
    # for every slice that supports it, so both run the same sequence.
    model.zero_grad(set_to_none=True)
    lm_loss(model(tokens), tokens).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    expected = expected_launches(grads)
    log(f"  launches per step derived from the layout: {expected}")
    synced = gradient_sync(grads)
    sync(dev)
    worst_rel = max(
        float(codec.relative_l2_error(grads[k], synced[k])) for k in grads
    )
    log(f"  largest per-parameter relative L2 error of the synced gradients: {worst_rel:.4f}")
    assert all(bool(torch.isfinite(v).all()) for v in synced.values())
    assert worst_rel < 0.5, worst_rel
    if cpu_check:
        t0 = time.perf_counter()
        os.environ["CGX_SRA_EPILOGUE"] = "fused"
        try:
            plain = gradient_sync({k: v.cpu() for k, v in grads.items()})
        finally:
            os.environ.pop("CGX_SRA_EPILOGUE")
        mismatched = [k for k in grads if not _same_bits(synced[k].cpu(), plain[k])]
        log(f"  kernel-path sync vs plain CPU sync: {len(grads) - len(mismatched)}/{len(grads)} "
            f"parameters bit-identical ({time.perf_counter() - t0:.1f} s)")
        assert not mismatched, mismatched[:5]
    del synced, grads

    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    step = make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device=dev)
    codec_cuda.reset_launch_counts()
    losses = [float(step(tokens)) for _ in range(steps)]
    sync(dev)
    launches = dict(codec_cuda.LAUNCHES)
    log(f"  losses: {losses}")
    log(f"  launches over {steps} steps: {launches}")
    assert all(np.isfinite(losses)), losses
    want = {k: v * steps for k, v in expected.items()}
    assert launches == want, (launches, want)
    return {"model": model, "tokens": tokens, "opt": opt, "step": step,
            "launches": launches, "expected": expected, "losses": losses,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def new_run(dev, cfg, stochastic_seed=None):
    """GPT-2 from the seed with a fresh Adam and ``make_train_step``: the
    same start as :func:`gpt2_slice`'s steps."""
    import torch

    from torch_cgx_tpu_torch.models import GPT2, lm_loss
    from torch_cgx_tpu_torch.parallel import make_train_step

    model = GPT2(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    return model, make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device=dev,
                                  stochastic_seed=stochastic_seed)


def stochastic_phase(dev, cfg, sl: dict) -> dict:
    """Phase 4 (f): the slice under ``CGX_STOCHASTIC_ROUNDING=1``, built with
    ``make_train_step(stochastic_seed=SR_SEED)`` through the world-size-1
    proxy. One backward's gradients synced with the first step's key
    (``fold_in(key(SR_SEED), 0)``) through the kernels and through the plain
    versions on the CPU must agree bit for bit, and differ from the
    round-to-nearest sync; then one step with the counters reset, its
    launches against the layout's (``LaunchModel``, stochastic). Returns the
    step for phase 5's profile. ``CGX_STOCHASTIC_ROUNDING`` stays set for
    the caller to clear."""
    import torch

    from torch_cgx_tpu_torch.models import lm_loss
    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.parallel import gradient_sync
    from torch_cgx_tpu_torch.utils import prng

    os.environ["CGX_STOCHASTIC_ROUNDING"] = "1"
    tokens = sl["tokens"]
    model, step = new_run(dev, cfg, stochastic_seed=SR_SEED)
    lm_loss(model(tokens), tokens).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    key = prng.fold_in(prng.key(SR_SEED), 0)
    expected = expected_launches(grads, stochastic=True)
    t0 = time.perf_counter()
    synced = gradient_sync(grads, key=key)
    det = gradient_sync(grads)
    sync(dev)
    moved = sum(not _same_bits(synced[k], det[k]) for k in grads)
    plain = _plain_cpu(gradient_sync, {k: v.cpu() for k, v in grads.items()}, key=key)
    mismatched = [k for k in grads if not _same_bits(synced[k].cpu(), plain[k])]
    log(f"  (f) stochastic sync (key fold_in(key({SR_SEED:#x}), 0)), kernels vs plain CPU: "
        f"{len(grads) - len(mismatched)}/{len(grads)} parameters bit-identical; {moved} differ from "
        f"the round-to-nearest sync ({time.perf_counter() - t0:.1f} s)")
    assert not mismatched, mismatched[:5]
    assert moved, "stochastic rounding did not move the synced gradients"
    del synced, det, plain, grads
    codec_cuda.reset_launch_counts()
    loss = float(step(tokens))
    sync(dev)
    launches = dict(codec_cuda.LAUNCHES)
    log(f"  (f) one stochastic step: loss {loss:.4f}; launches {launches} (the layout's: {expected})")
    assert np.isfinite(loss) and launches == expected, (loss, launches, expected)
    return {"model": model, "step": step, "tokens": tokens, "launches": launches}


def bf16_phase(dev, cfg, tokens, steps: int) -> dict:
    """Phase 4 (g): the GPT-2 124M slice with its parameters cast to bf16
    (``model.to(torch.bfloat16)``; Adam on the bf16 parameters), whose
    gradient tree syncs as bf16 groups. One backward's bf16 gradients
    synced through the kernels and through the plain versions on the CPU
    must agree bit for bit, every B1 and B3 launch of that sync reading its
    bf16 operand itself (``WIRE16_LAUNCHES``); then ``steps`` steps under
    ``CGX_PALLAS_DB=off`` and the same steps from the seed under ``on``,
    each with its launches held against the layout (``expected_launches``
    of the bf16 tree: 64 MB slices of 2-byte values), finite losses, and
    under ``on`` losses and parameters bit-identical to ``off``'s. Returns
    the ``off`` run for phase 5."""
    import torch

    from torch_cgx_tpu_torch.models import GPT2, lm_loss
    from torch_cgx_tpu_torch.ops import codec, codec_cuda
    from torch_cgx_tpu_torch.parallel import allreduce, gradient_sync, make_train_step

    def run():
        model = GPT2(cfg, device=dev, generator=torch.Generator().manual_seed(SEED)).to(torch.bfloat16)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
        return model, opt, make_train_step(model, lambda m, t: lm_loss(m(t), t), opt, device=dev)

    model, opt, step = run()
    lm_loss(model(tokens), tokens).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    assert {g.dtype for g in grads.values()} == {torch.bfloat16}
    pl = allreduce.sorted_items(grads)
    chunks = []
    for g in allreduce._group_leaves(pl, compress_small=False):
        if g.cc.enabled:
            n = sum(pl[i][1].numel() for i in g.indices)
            chunks += [divmod(codec.num_buckets(ln, BUCKET), 32) for _, ln in allreduce._fusion_slices(n, 2)]
    expected = expected_launches(grads)
    log(f"  (g) bf16 parameters: {sum(g.numel() for g in grads.values())} values in bf16; compressed "
        f"fusion slices (whole chunks, tail buckets): {sorted(chunks)}")
    log(f"  (g) launches per step derived from the bf16 layout: {expected}")
    t0 = time.perf_counter()
    codec_cuda.reset_launch_counts()
    synced = gradient_sync(grads)
    sync(dev)
    wire, launched = dict(codec_cuda.WIRE16_LAUNCHES), dict(codec_cuda.LAUNCHES)
    plain = _plain_cpu(gradient_sync, {k: v.cpu() for k, v in grads.items()})
    mismatched = [k for k in grads if not _same_bits(synced[k].cpu(), plain[k])]
    worst_rel = max(float(codec.relative_l2_error(grads[k].float(), synced[k].float())) for k in grads)
    log(f"  (g) bf16 sync, kernels vs plain CPU: {len(grads) - len(mismatched)}/{len(grads)} parameters "
        f"bit-identical ({time.perf_counter() - t0:.1f} s); largest relative L2 error {worst_rel:.4f}; "
        f"launches reading bf16 {wire} of {launched}")
    assert not mismatched, mismatched[:5]
    assert all(synced[k].dtype == torch.bfloat16 for k in synced)
    assert launched == expected, (launched, expected)
    for k in ("codec_quantize", "codec_sra_epilogue"):
        assert wire[k] == launched[k] > 0, (k, wire, launched)
    del synced, plain
    out = {"expected": expected, "grads": grads}
    for db in ("off", "on"):
        os.environ["CGX_PALLAS_DB"] = db
        if db == "on":
            model, opt, step = run()
            expected = expected_launches(grads)
            log(f"  (g) CGX_PALLAS_DB=on: launches per step derived from the layout: {expected}")
        codec_cuda.reset_launch_counts()
        losses = [float(step(tokens)) for _ in range(steps)]
        sync(dev)
        launches, wire = dict(codec_cuda.LAUNCHES), dict(codec_cuda.WIRE16_LAUNCHES)
        log(f"  (g) CGX_PALLAS_DB={db}: losses {losses}; launches over {steps} steps {launches}; "
            f"reading bf16 {wire}")
        assert np.all(np.isfinite(losses)), losses
        assert launches == {k: v * steps for k, v in expected.items()}, (launches, expected)
        assert all(wire[k] == launches[k] for k in wire if k != "codec_reduce_rows"), (wire, launches)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        if db == "off":
            out.update(model=model, opt=opt, step=step, tokens=tokens, losses=losses,
                       launches=launches, params=params)
            continue
        assert any(launches[k] for k in DB_KEYS), launches
        assert losses == out["losses"], (losses, out["losses"])
        diff = [n for n in params if not _same_bits(params[n], out["params"][n])]
        log(f"  (g) parameters after {steps} steps: {len(params) - len(diff)}/{len(params)} "
            f"bit-identical to the same steps under CGX_PALLAS_DB=off")
        assert not diff, diff[:5]
        out["launches_on"] = launches
        del model, opt, step, params
    os.environ["CGX_PALLAS_DB"] = "off"
    out.pop("params")
    return out


def step_shapes(named) -> list:
    """The autotune keys the world-size-1 step looks up where it may take a
    pipelined kernel: ``(kind, chunks)`` of every compressed fusion slice of
    whole chunks ("flat": its quantize and decode) and of every one the
    fused epilogue takes ("epilogue", rows=1)."""
    from torch_cgx_tpu_torch.ops import autotune, codec, dispatch
    from torch_cgx_tpu_torch.parallel import allreduce

    model = LaunchModel(next(iter(named.values())).device)
    paths_leaves = allreduce.sorted_items(named)
    shapes = set()
    for g in allreduce._group_leaves(paths_leaves, compress_small=False):
        if not g.cc.enabled:
            continue
        n = sum(paths_leaves[i][1].numel() for i in g.indices)
        for _, ln in allreduce._fusion_slices(n, 4):
            c_r, t_r = divmod(codec.num_buckets(ln, BUCKET), codec.CHUNK_BUCKETS)
            if c_r and not t_r:
                shapes.add((autotune.KIND_FLAT, c_r))
                if dispatch.fused_epilogue_would_run(model._stand_in(1, ln, g.cc)):
                    shapes.add((autotune.KIND_EPILOGUE, c_r))
    return sorted(shapes)


def sweep(dev, shapes) -> dict:
    """Phase 4 (a): ``autotune.tune`` over each shape. The candidates: the
    single-stage kernels once (``db=False``: they ignore ``tc``), and the
    pipelined ones at every ``tc`` that ``snap_to_divisor`` keeps under the
    shape's cap (``db_tc_cap`` at its chunk count on this card; "flat": the
    larger of the quantize's and the decode's, each kernel capped to its
    own as the batch functions do). ``measure``: the kernels alone, a burst
    of back-to-back calls queued behind a sleep kernel (``time_burst``),
    for "flat" a quantize then a decode (the entry both share), for
    "epilogue" the rows=1 epilogue. Every candidate must measure: a
    pipelined kernel that fails here fails the phase."""
    import torch

    from torch_cgx_tpu_torch.ops import autotune, codec_cuda

    rng = np.random.default_rng(SEED + 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    winners = {}
    for kind, chunks in shapes:
        n = chunks * 32 * BUCKET
        x = torch.from_numpy(fuzz_operand(rng, n, 0)).to(dev)
        if kind == autotune.KIND_FLAT:
            caps = {k: codec_cuda.db_tc_cap(k, BITS, BUCKET, chunks=chunks, sms=sms)
                    for k in ("quantize", "dequantize")}
            cap = max(caps.values())

            def run(c, x=x, caps=caps):
                if not c.db:
                    return lambda: codec_cuda.dequantize_chunks(
                        *codec_cuda.quantize_chunks(x, BITS, BUCKET), BITS, BUCKET)
                tq, td = (codec_cuda._pipe_tc(chunks, caps[k], c) for k in ("quantize", "dequantize"))
                return lambda: codec_cuda.dequantize_chunks_db(
                    *codec_cuda.quantize_chunks_db(x, BITS, BUCKET, tq), BITS, BUCKET, td)
        else:
            cap = codec_cuda.db_tc_cap("epilogue", BITS, BUCKET, chunks=chunks, sms=sms)
            w, m = codec_cuda.quantize_chunks(x, BITS, BUCKET)

            def run(c, w=w[None], m=m[None], cap=cap):
                if not c.db:
                    return lambda: codec_cuda.sra_epilogue_chunks(w, m, None, -1, BITS, BUCKET)
                tc = codec_cuda._pipe_tc(chunks, cap, c)
                return lambda: codec_cuda.sra_epilogue_chunks_db(w, m, None, -1, BITS, BUCKET, tc)
        tcs = sorted({autotune.snap_to_divisor(t, chunks, cap) for t in range(1, cap + 1)})
        cands = [autotune.TunedConfig(tc=1, db=False)] + [autotune.TunedConfig(tc=tc, db=True)
                                                          for tc in tcs]
        measured = {}

        def measure(c):
            ms = time_burst(run(c))
            measured[c] = ms
            return ms / 1e3

        win = autotune.tune(kind, cands, measure, n_chunks=chunks, bucket_size=BUCKET, bits=BITS,
                            ws=1 if kind == autotune.KIND_EPILOGUE else 0, input_bytes=4 * n)
        assert len(measured) == len(cands), (kind, chunks, cands, measured)
        winners[(kind, chunks)] = win
        log(f"  {kind}/c{chunks}: {len(cands)} candidates, kernels alone ("
            + ", ".join(f"{'tc=' + str(c.tc) + ' db' if c.db else 'single-stage'} {v:.5f} ms"
                        for c, v in measured.items())
            + f"); winner {'db tc=' + str(win.tc) if win.db else 'single-stage'}")
    log(f"  cache file {autotune.cache_path()}: {len(winners)} entries")
    return winners


DB_KEYS = ("codec_quantize_db", "codec_dequantize_db", "codec_sra_epilogue_db")


def db_phase(dev, cfg, sl: dict, steps: int) -> dict:
    """Phase 4's pipelined path, after :func:`gpt2_slice`'s steps under
    ``CGX_PALLAS_DB=off``: (b) the same steps from the seed under ``on``,
    launches held against the layout and parameters bit-identical to
    ``off``; (a) the autotune sweep over the step's shapes into a fresh
    cache directory; (c) one step under ``auto`` over that cache, which must
    hit it and launch the pipelined kernels exactly where the winners say.
    The cache directory is removed at the end. Returns the step planner's
    model calibrated from the sweep (``CostModel.from_telemetry``) too."""
    from torch_cgx_tpu_torch.ops import autotune, codec_cuda
    from torch_cgx_tpu_torch.parallel import planner

    tokens = sl["tokens"]
    log("  (b) forced: CGX_PALLAS_DB=on, the same steps from the seed")
    os.environ["CGX_PALLAS_DB"] = "on"
    model, step = new_run(dev, cfg)
    params = dict(model.named_parameters())
    expected = expected_launches(params)
    log(f"  launches per step derived from the layout: {expected}")
    assert all(expected[k] > 0 for k in DB_KEYS), expected
    codec_cuda.reset_launch_counts()
    losses = [float(step(tokens)) for _ in range(steps)]
    sync(dev)
    launches = dict(codec_cuda.LAUNCHES)
    log(f"  losses: {losses}; launches over {steps} steps: {launches}")
    assert launches == {k: v * steps for k, v in expected.items()}, (launches, expected)
    assert not any(codec_cuda.DB_GATED.values()), codec_cuda.DB_GATED
    assert losses == sl["losses"], (losses, sl["losses"])
    diff = [n for n, p in params.items() if not _same_bits(p.detach(), sl["params"][n])]
    log(f"  parameters after {steps} steps: {len(params) - len(diff)}/{len(params)} "
        f"bit-identical to the same steps under CGX_PALLAS_DB=off")
    assert not diff, diff[:5]

    home = os.environ["CGX_AUTOTUNE_DIR"]
    with tempfile.TemporaryDirectory() as tmp:
        log(f"  (a) sweep into a fresh cache directory {tmp}")
        os.environ["CGX_AUTOTUNE_DIR"] = tmp
        autotune.invalidate("sweep")
        winners = sweep(dev, step_shapes(params))

        log("  (c) tuned: CGX_PALLAS_DB=auto over the swept cache, one step")
        os.environ["CGX_PALLAS_DB"] = "auto"
        autotune.invalidate("reload the swept cache from disk")
        tuned_expected = expected_launches(params)
        before = autotune.stats()
        codec_cuda.reset_launch_counts()
        loss = float(step(tokens))
        sync(dev)
        tuned = dict(codec_cuda.LAUNCHES)
        hits = autotune.stats()["hits"] - before["hits"]
        on = sorted(f"{k}/c{c}" for (k, c), w in winners.items() if w.db)
        log(f"  winners with db=True: {on or 'none'}; loss {loss}; cache hits in the step {hits}")
        log(f"  launches derived from the layout and the cache: {tuned_expected}; counted: {tuned}")
        assert np.isfinite(loss) and hits > 0, (loss, hits)
        assert tuned == tuned_expected, (tuned, tuned_expected)
        assert any(tuned[k] for k in DB_KEYS) == bool(on), (tuned, on)
        # The step planner's model from the card's own rates: the sweep's
        # entries in the memo (phase 7 writes it to its model file).
        planner_model = planner.CostModel.from_telemetry()
        log(f"  the planner's model from the swept cache: {planner_model.as_dict()}")
    os.environ["CGX_AUTOTUNE_DIR"] = home
    os.environ["CGX_PALLAS_DB"] = "off"
    autotune.invalidate("sweep done")
    return {"launches": launches, "winners": winners, "planner_model": planner_model}


def lowering_phase(dev, cfg, sl: dict, steps: int) -> dict:
    """Phase 4's two lowerings, after :func:`gpt2_slice`'s steps (div
    encode, sum pack): (d) the same steps from the seed under
    ``CGX_PALLAS_PACK=butterfly``, launches held against the layout, losses
    and parameters bit-identical to the sum pack's; (e) one step under
    ``CGX_CODEC_ENCODE=mul`` through :func:`gpt2_slice` (its launches held
    against the layout, its loss finite, one gradient sync through the
    kernels bit-identical to the plain versions' on the CPU)."""
    from torch_cgx_tpu_torch.ops import codec_cuda

    log("  (d) CGX_PALLAS_PACK=butterfly: the same steps from the seed")
    os.environ["CGX_PALLAS_PACK"] = "butterfly"
    try:
        model, step = new_run(dev, cfg)
        params = dict(model.named_parameters())
        expected = expected_launches(params)
        codec_cuda.reset_launch_counts()
        losses = [float(step(sl["tokens"])) for _ in range(steps)]
        sync(dev)
        launches = dict(codec_cuda.LAUNCHES)
    finally:
        del os.environ["CGX_PALLAS_PACK"]
    log(f"  losses: {losses}; launches over {steps} steps: {launches}")
    assert launches == {k: v * steps for k, v in expected.items()}, (launches, expected)
    assert launches == sl["launches"], (launches, sl["launches"])
    assert losses == sl["losses"], (losses, sl["losses"])
    diff = [n for n, p in params.items() if not _same_bits(p.detach(), sl["params"][n])]
    log(f"  parameters after {steps} steps: {len(params) - len(diff)}/{len(params)} "
        f"bit-identical to the same steps under the sum pack")
    assert not diff, diff[:5]
    del model, step, params

    log("  (e) CGX_CODEC_ENCODE=mul: one step from the seed")
    os.environ["CGX_CODEC_ENCODE"] = "mul"
    try:
        mul = gpt2_slice(dev, cfg, BATCH, SEQ, 1)
    finally:
        del os.environ["CGX_CODEC_ENCODE"]
    return {"butterfly": launches, "mul": mul["launches"]}


def variant_sass(lib) -> None:
    """Log the SASS of B9's three bodies (4 bits, one position a thread)
    against B1's instance they are cut from (div, sum, round to nearest,
    f32): each one's instructions and the opcodes whose counts differ
    from B1's (:func:`sass_opcodes`)."""
    t0 = time.perf_counter()
    counts, how = sass_opcodes(lib, VARIANT_SASS_KERNELS)
    b1 = counts.pop(VARIANT_SASS_B1)
    assert len(counts) == 3, sorted(counts)
    parts = [f"B1 {sum(b1.values())}"]
    for key, c in sorted(counts.items()):
        variant = ("nometa", "metalane", "read")[int(re.search(r"ILi4ELi(\d)E", key).group(1))]
        diff = {k: c[k] - b1[k] for k in set(c) | set(b1) if c[k] != b1[k]}
        parts.append(f"{variant} {sum(c.values())} (" + ", ".join(
            f"{k} {v:+d}" for k, v in sorted(diff.items(), key=lambda kv: -abs(kv[1]))) + ")")
    log(f"  SASS instructions, 4 bits, one position a thread (cuobjdump of {how}, "
        f"{time.perf_counter() - t0:.1f} s): " + "; ".join(parts))


def qbench_phase(dev, copy_gbps: float) -> dict:
    """Phase 6: the port's qbench at its defaults, each of its eight
    variants in this process, then ``current``, ``nometa``, ``metalane`` and
    ``read`` at ``--mb 9`` (the step's 144-chunk launch), the launch
    counters reset just before and read just after. Then B1's split at both
    sizes and at phase 5's 64 MB slice, from qbench's slopes and from bursts
    (the kernels alone, behind a sleep kernel, on cold inputs as
    ``shapebench`` times the step's shapes: at 144 chunks a slope counts the
    host's time a call), and the three bodies' SASS beside B1's:
    the meta store is current - nometa, the encode and pack nometa - read,
    and read's GB/s stands beside phase 5's copy yardstick (``copy_gbps``).
    The bursts' current is B1's kernel (``quantize_chunks``), qbench's the
    batch function. Returns the records and the variant kernel's
    launches."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.tools import qbench, shapebench

    codec_cuda.reset_launch_counts()
    records = {}
    for variant in qbench.VARIANTS:
        records[variant] = qbench.main([variant, "--mb", str(QBENCH_MB)])
        torch.cuda.empty_cache()
    for variant in QBENCH_SPLIT:
        records[f"{variant} --mb {QBENCH_STEP_MB}"] = qbench.main(
            [variant, "--mb", str(QBENCH_STEP_MB)])
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = codec_cuda.LAUNCHES["codec_quantize_variant"]
    log(f"  {'variant':16s} {'t_ms':>8s} {'GB/s in':>8s} {'bound_ms':>9s} {'% of bound':>10s}  bytes")
    for variant, r in records.items():
        assert r["t_ms"] is not None, r
        log(f"  {variant:16s} {r['t_ms']:8.4f} {r['gbps_in']:8.1f} {r['bound_ms']:9.4f} "
            f"{r['pct_of_bound']:10.1f}  {r['bytes']}")
    log(f"  variant kernel launches in the phase: {launches}")
    assert launches > 0

    # Bursts as shapebench times the step's shapes: each launch on its own
    # input (rotating through ROTATE_BYTES of them) after an L2 flush, so a
    # 9 MB input is not read from the L2; groups in turns, the order
    # reversed every other group.
    flush = torch.empty(shapebench.FLUSH_BYTES // 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bursts, spread = {}, {}
    for mb in (QBENCH_MB, 4 * FLAT_N // 2**20, QBENCH_STEP_MB):
        n = mb * 2**20 // 4
        copies = -(-shapebench.ROTATE_BYTES // qbench.variant_bytes("current", n, BITS, BUCKET, 8))
        xs = [torch.randn(n, generator=gen, device=dev) for _ in range(copies)]
        runs = {"current": lambda i: codec_cuda.quantize_chunks(xs[i % copies], BITS, BUCKET)}
        for variant in QBENCH_SPLIT[1:]:
            runs[variant] = lambda i, v=variant: codec_cuda.quantize_variant_chunks(
                xs[i % copies], v, BITS, BUCKET)
        t = {v: [] for v in runs}
        for g in range(QBENCH_GROUPS):
            for v in (list(runs) if g % 2 == 0 else list(reversed(runs))):
                t[v].append(shapebench.burst_ms(runs[v], QBENCH_LAUNCHES, flush))
        bursts[mb] = {v: statistics.median(ts) for v, ts in t.items()}
        spread[mb] = {v: max(ts) - min(ts) for v, ts in t.items()}
        del xs, runs
    del flush
    torch.cuda.empty_cache()
    for mb, b in bursts.items():
        n = mb * 2**20 // 4
        g = codec_cuda.cluster_geometry(n // (32 * BUCKET), BUCKET, BITS,
                                        codec_cuda._sm_count(dev.index or 0))
        slope = None
        if mb in (QBENCH_MB, QBENCH_STEP_MB):
            slope = {v: records[v if mb == QBENCH_MB else f"{v} --mb {mb}"]["t_ms"]
                     for v in QBENCH_SPLIT}
        read_bytes = qbench.variant_bytes("read", n, BITS, BUCKET, 8)
        log(f"  {mb} MB ({n // (32 * BUCKET)} chunks, k = {g.k} x {g.threads} threads), burst ms "
            f"(median of {QBENCH_GROUPS} groups, max - min): "
            + ", ".join(f"{v} {b[v]:.4f} ({spread[mb][v]:.4f})" for v in QBENCH_SPLIT)
            + ("; slope ms: " + ", ".join(f"{v} {slope[v]:.4f}" for v in QBENCH_SPLIT) if slope
               else " (phase 5's slice; no qbench run)"))
        splits = (("burst", b), ("slope", slope)) if slope else (("burst", b),)
        for how, t in splits:
            log(f"    B1's split ({how}): meta store (current - nometa) {t['current'] - t['nometa']:.4f} ms, "
                f"encode + pack (nometa - read) {t['nometa'] - t['read']:.4f} ms, loads + reduce + "
                f"word stores (read) {t['read']:.4f} ms; metalane - nometa "
                f"{t['metalane'] - t['nometa']:+.4f} ms; read moves {read_bytes / t['read'] / 1e6:.1f} "
                f"GB/s against the copy's {copy_gbps:.1f} GB/s (phase 5)")
    variant_sass(codec_cuda.LIBRARY)
    return {"records": records, "launches": launches, "bursts": bursts}


# ---------------------------------------------------------------------------
# Phase 5: times.
# ---------------------------------------------------------------------------


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_burst(fn, iters: int = 20, groups: int = 3) -> float:
    """Median over ``groups`` of the milliseconds a call of ``fn()`` takes
    when ``iters`` calls run back to back, queued behind a sleep kernel
    (``shapebench.burst_ms``): the kernel alone, without the host's time
    between launches, which a single timed call of a short kernel counts."""
    from torch_cgx_tpu_torch.tools import shapebench

    return statistics.median(shapebench.burst_ms(lambda i: fn(), iters) for _ in range(groups))


def time_kernels(dev, n: int, name: str) -> tuple:
    """Each kernel and its plain version at the main path's flat slice, each
    pipelined kernel right after its single-stage sibling at the tile the
    forced run gives it (and the epilogues again at phase 7's flat-SRA
    shape); the multi-row reduce at phase 7's two shapes, the two-level one
    first. Returns the records and the yardstick: a device-to-device copy's
    GB/s, read and write."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.tools import shapebench
    from torch_cgx_tpu_torch.utils.device import mem_rate

    rate = mem_rate(name)
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(fuzz_operand(rng, n, 0)).to(dev)
    words, meta = codec_cuda.quantize_chunks(x, BITS, BUCKET)
    chunks = n // (32 * BUCKET)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tq, td, te = (codec_cuda._pipe_tc(chunks, codec_cuda.db_tc_cap(k, BITS, BUCKET, chunks=chunks,
                                                                   sms=sms))
                  for k in ("quantize", "dequantize", "epilogue"))

    def wire(m: int) -> int:
        return m * BITS // 8 + 8 * m // BUCKET

    # (kernel, shape, kernel call, plain call, bytes moved, f32 operations,
    # the library call computing the same function or None).
    runs = [
        ("codec_quantize", f"n={n}",
         lambda: codec_cuda.quantize_chunks(x, BITS, BUCKET),
         lambda: codec_cuda.quantize_chunks_plain(x, BITS, BUCKET),
         4 * n + wire(n), 8 * n, None),
        ("codec_quantize_db", f"n={n} tc={tq}",
         lambda: codec_cuda.quantize_chunks_db(x, BITS, BUCKET, tq),
         lambda: codec_cuda.quantize_chunks_db_plain(x, BITS, BUCKET),
         4 * n + wire(n), 8 * n, None),
        ("codec_dequantize", f"n={n}",
         lambda: codec_cuda.dequantize_chunks(words, meta, BITS, BUCKET),
         lambda: codec_cuda.dequantize_chunks_plain(words, meta, BITS, BUCKET),
         wire(n) + 4 * n, 4 * n, None),
        ("codec_dequantize_db", f"n={n} tc={td}",
         lambda: codec_cuda.dequantize_chunks_db(words, meta, BITS, BUCKET, td),
         lambda: codec_cuda.dequantize_chunks_db_plain(words, meta, BITS, BUCKET),
         wire(n) + 4 * n, 4 * n, None),
        ("codec_sra_epilogue", f"n={n}",
         lambda: codec_cuda.sra_epilogue_chunks(words[None], meta[None], None, -1, BITS, BUCKET),
         lambda: codec_cuda.sra_epilogue_chunks_plain(words[None], meta[None], None, -1, BITS, BUCKET),
         2 * wire(n), 12 * n, None),
        ("codec_sra_epilogue_db", f"n={n} tc={te}",
         lambda: codec_cuda.sra_epilogue_chunks_db(words[None], meta[None], None, -1, BITS, BUCKET, te),
         lambda: codec_cuda.sra_epilogue_chunks_db_plain(words[None], meta[None], None, -1, BITS, BUCKET),
         2 * wire(n), 12 * n, None),
    ]
    # B5 and B6: B1's and B2's kernels on the whole chunks of the tail
    # slice (307 chunks; its 26 tail buckets go through the plain codec).
    head = (TAIL_N // (32 * BUCKET)) * 32 * BUCKET
    xt = torch.from_numpy(fuzz_operand(rng, head, 0)).to(dev)
    wt, mtail = codec_cuda.quantize_chunks(xt, BITS, BUCKET)
    runs += [
        ("codec_quantize", f"B5: the tail slice's {head // (32 * BUCKET)} chunks, n={head}",
         lambda: codec_cuda.quantize_chunks(xt, BITS, BUCKET),
         lambda: codec_cuda.quantize_chunks_plain(xt, BITS, BUCKET),
         4 * head + wire(head), 8 * head, None),
        ("codec_dequantize", f"B6: the tail slice's {head // (32 * BUCKET)} chunks, n={head}",
         lambda: codec_cuda.dequantize_chunks(wt, mtail, BITS, BUCKET),
         lambda: codec_cuda.dequantize_chunks_plain(wt, mtail, BITS, BUCKET),
         wire(head) + 4 * head, 4 * head, None),
    ]
    # B9: the variant kernel's nometa body at qbench's 128 MB and at its
    # --mb 9, the step's 144-chunk mlp_in launch (phase 6).
    xv = torch.from_numpy(fuzz_operand(rng, 2 * n, 0)).to(dev)
    for m in (2 * n, QBENCH_STEP_CHUNKS * 32 * BUCKET):
        runs.append((
            "codec_quantize_variant", f"nometa n={m}",
            lambda m=m: codec_cuda.quantize_variant_chunks(xv[:m], "nometa", BITS, BUCKET),
            lambda m=m: codec_cuda.quantize_variant_chunks_plain(xv[:m], "nometa", BITS, BUCKET),
            4 * m + wire(m), 8 * m, None,
        ))
    # Phase 7's flat-SRA epilogue: ws rows of a rank's chunk, the raw own
    # row in place of row 1; the own row's words are not read.
    c = n // SRA_WS
    rows = torch.from_numpy(np.stack([fuzz_operand(rng, c, 0) for _ in range(SRA_WS)])).to(dev)
    q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
    w4, m4, raw4 = q.packed.contiguous(), q.meta.contiguous(), rows[1].contiguous()
    te4 = codec_cuda._pipe_tc(c // (32 * BUCKET), codec_cuda.db_tc_cap(
        "epilogue", BITS, BUCKET, chunks=c // (32 * BUCKET), sms=sms))
    ep_bytes = (SRA_WS - 1) * wire(c) + 4 * c + wire(c)
    runs += [
        ("codec_sra_epilogue", f"ws={SRA_WS} own=1 n={c}",
         lambda: codec_cuda.sra_epilogue_chunks(w4, m4, raw4, 1, BITS, BUCKET),
         lambda: codec_cuda.sra_epilogue_chunks_plain(w4, m4, raw4, 1, BITS, BUCKET),
         ep_bytes, (3 * SRA_WS + 8) * c, None),
        ("codec_sra_epilogue_db", f"ws={SRA_WS} own=1 n={c} tc={te4}",
         lambda: codec_cuda.sra_epilogue_chunks_db(w4, m4, raw4, 1, BITS, BUCKET, te4),
         lambda: codec_cuda.sra_epilogue_chunks_db_plain(w4, m4, raw4, 1, BITS, BUCKET),
         ep_bytes, (3 * SRA_WS + 8) * c, None),
    ]
    # The multi-row reduce: decode (a multiply and an add) per value of each
    # row but the own one, fold (an add) per value of each row after the
    # first; bytes as shapebench counts them (the own row's payload is not
    # read). Two-level: 2 rows of half a slice with the raw own row;
    # all-to-all: 4 rows of a whole slice.
    for rows_n, m, own in ((MR_INTRA, n // MR_INTRA, 0), (MR_WS, n, None)):
        rows = torch.from_numpy(
            np.stack([fuzz_operand(rng, m, 0) for _ in range(rows_n)])
        ).to(dev)
        q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
        w, mt = q.packed.contiguous(), q.meta.contiguous()
        raw = None if own is None else rows[own].contiguous()
        o = -1 if own is None else own
        runs.append((
            "codec_reduce_rows", f"rows={rows_n} n={m} own={own}",
            lambda w=w, mt=mt, raw=raw, o=o: codec_cuda.reduce_rows_chunks(w, mt, raw, o, BITS, BUCKET),
            lambda w=w, mt=mt, raw=raw, o=o: codec_cuda.reduce_rows_chunks_plain(w, mt, raw, o, BITS, BUCKET),
            shapebench.shape_bytes("reduce", m // (32 * BUCKET), rows_n, o, BUCKET),
            (2 * (rows_n - (own is not None)) + rows_n - 1) * m, None,
        ))
    out = []
    for k, shape, kern, plain, nbytes, ops, library in runs:
        # Alternate kernel and plain version: kernel, plain, plain, kernel;
        # then the kernel's burst time.
        k1 = time_cuda(kern)
        p1 = time_cuda(plain, iters=5)
        p2 = time_cuda(plain, iters=5)
        k2 = time_cuda(kern)
        burst_ms = time_burst(kern)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        t_bytes = nbytes / rate * 1e3
        t_ops = ops / F32_RATE * 1e3
        bound = max(t_bytes, t_ops)
        log(f"  {k:20s} {shape}: {ms:.4f} ms, burst {burst_ms:.4f} ms (plain {plain_ms:.3f} ms); "
            f"{nbytes} bytes, {ops} operations, bound {bound:.4f} ms by "
            f"{'bytes' if t_bytes >= t_ops else 'operations'} = {100 * bound / ms:.1f}% of bound")
        out.append({"name": k, "shape": shape, "ms": ms, "burst_ms": burst_ms, "plain_ms": plain_ms,
                    "library_ms": library, "bound_ms": bound,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes})
    src = torch.empty(n, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_cuda(lambda: dst.copy_(src))
    log(f"  yardstick: device-to-device copy_ of {4 * n} bytes: {copy_ms:.4f} ms, "
        f"{8 * n / copy_ms / 1e6:.1f} GB/s read+write")
    return out, 8 * n / copy_ms / 1e6


def time_mm32(dev, name: str) -> list:
    """B8 on float32 operands at phase 7's three dense-layer shapes (K =
    MM_K, divisor MR_WS, the own raw row of rank 1 of MR_WS, as the producer
    calls it), as bursts in turns: the route these operands take (the split
    pass and the split-TF32 kernel on the tensor cores), the FFMA kernel
    (``_route="ffma"``), the split pass alone, and float32 ``torch.matmul``
    of the same product (TF32 off: the library call, without the divide and
    the quantize): tc, ffma, split, library, library, split, ffma, tc. Then
    one timed call of each, and of the plain versions and the unfused route
    (that product, the divide and the dispatcher's quantize of the (ws,
    chunk) rows: the yardstick of ``CGX_PRODUCER_FUSE=auto``), in turns.
    Bounds: the larger of the bytes (f32 operands read once, the payload
    and the raw row written once) over the memory rate and the operations
    over the rate of the route: three tf32 products a product at the TF32
    tensor-core rate (the kernel's), a multiply and an add at the f32 rate
    (the FFMA kernel's, beside it); the split pass's bytes (the operands
    read, the hi and lo planes written). Returns the kernels line's records
    of ``codec_matmul_quantize`` and ``codec_tf32_split`` (``mlp_in``'s,
    the first shape)."""
    import torch

    from torch_cgx_tpu_torch.config import default_compression_config
    from torch_cgx_tpu_torch.ops import codec_cuda, dispatch
    from torch_cgx_tpu_torch.utils.device import mem_rate

    rate = mem_rate(name)
    rng = np.random.default_rng(SEED + 4)
    own = (1, MR_WS)
    cc = dataclasses.replace(default_compression_config(), bits=BITS, bucket_size=BUCKET)
    out = []
    for layer, (din, o) in MM_SHAPES.items():
        x2, g2 = (torch.from_numpy(rng.standard_normal((MM_K, c)).astype(np.float32)).to(dev)
                  for c in (din, o))
        fns = {
            "kern": lambda: codec_cuda.matmul_quantize_chunks(x2, g2, MR_WS, BITS, BUCKET, own_row=own),
            "ffma": lambda: codec_cuda.matmul_quantize_chunks(x2, g2, MR_WS, BITS, BUCKET, own_row=own,
                                                              _route="ffma"),
            "split": lambda: codec_cuda.tf32_split_transpose(x2, g2),
            "library": lambda: torch.matmul(x2.t(), g2),
            "plain": lambda: codec_cuda.matmul_quantize_chunks_plain(x2, g2, MR_WS, BITS, BUCKET, own_row=own),
            "split_plain": lambda: codec_cuda.tf32_split_transpose_plain(x2, g2),
            "unfused": lambda: dispatch.quantize_batch((torch.matmul(x2.t(), g2) / MR_WS).view(MR_WS, -1), cc),
        }
        before = codec_cuda.MM_TC_LAUNCHES["launches"]
        fns["kern"]()
        assert codec_cuda.MM_TC_LAUNCHES["launches"] == before + 1, "the timed shape left the tensor cores"
        burst = {k: [] for k in ("kern", "ffma", "split", "library")}
        for k in ("kern", "ffma", "split", "library", "library", "split", "ffma", "kern"):
            burst[k].append(time_burst(fns[k]))
        burst = {k: min(v) for k, v in burst.items()}
        order = ("kern", "ffma", "split", "library", "unfused", "plain", "split_plain")
        call = {k: [] for k in order}
        for k in order + order[::-1]:
            call[k].append(time_cuda(fns[k], iters=5 if "plain" in k else 20))
        call = {k: min(v) for k, v in call.items()}
        n = din * o
        kp = -(-MM_K // codec_cuda.MM_TF32_BK) * codec_cuda.MM_TF32_BK
        nbytes = 4 * MM_K * (din + o) + n * BITS // 8 + 8 * n // BUCKET + 4 * n // MR_WS
        ops = 2 * MM_K * n
        t_bytes = nbytes / rate * 1e3
        bound = max(t_bytes, 3 * ops / TF32_RATE * 1e3)
        ffma_bound = max(t_bytes, ops / F32_RATE * 1e3)
        split_bytes = 4 * MM_K * (din + o) + 8 * kp * (din + o)
        split_bound = split_bytes / rate * 1e3
        tiles = codec_cuda.mm_tc_tiles(din, o)
        shape = f"{layer} K={MM_K} {din}x{o} float32"
        r = {"name": "codec_matmul_quantize", "shape": shape, "ms": call["kern"], "burst_ms": burst["kern"],
             "plain_ms": call["plain"], "library_ms": call["library"], "bound_ms": bound,
             "bound_by": "bytes" if t_bytes >= 3 * ops / TF32_RATE * 1e3 else "operations",
             "ffma_ms": call["ffma"], "ffma_burst_ms": burst["ffma"], "ffma_bound_ms": ffma_bound,
             "library_burst_ms": burst["library"], "unfused_ms": call["unfused"],
             "split_burst_ms": burst["split"], "bytes": nbytes, "tiles": tiles[0] * tiles[1]}
        sp = {"name": "codec_tf32_split", "shape": shape, "ms": call["split"], "burst_ms": burst["split"],
              "plain_ms": call["split_plain"], "library_ms": None, "bound_ms": split_bound,
              "bound_by": "bytes", "bytes": split_bytes}
        log(f"  codec_matmul_quantize {shape}: tensor cores (split TF32, {r['tiles']} tiles) burst "
            f"{r['burst_ms']:.4f} ms, of it the split pass {burst['split']:.4f}; FFMA kernel "
            f"{r['ffma_burst_ms']:.4f} ({r['ffma_burst_ms'] / r['burst_ms']:.2f}x the tensor cores' time); "
            f"torch.matmul f32 {r['library_burst_ms']:.4f} ({r['burst_ms'] / r['library_burst_ms']:.2f}x the "
            f"library); per call {r['ms']:.4f} ms (FFMA {r['ffma_ms']:.4f}, library {r['library_ms']:.4f}, "
            f"unfused route {r['unfused_ms']:.4f}, plain {r['plain_ms']:.3f}); {nbytes} bytes, {ops} "
            f"operations, bound {bound:.4f} ms split TF32 ({100 * bound / r['burst_ms']:.1f}% of it a burst), "
            f"{ffma_bound:.4f} ms FFMA")
        log(f"  codec_tf32_split      {shape}: burst {sp['burst_ms']:.4f} ms, per call {sp['ms']:.4f} (plain "
            f"{sp['plain_ms']:.3f}); {split_bytes} bytes, bound {split_bound:.4f} ms "
            f"({100 * split_bound / sp['burst_ms']:.1f}% of it a burst)")
        out += [r, sp]
    return out[:2]


def time_mm16(dev, name: str) -> dict:
    """B8 on bf16 operands at phase 7's three dense-layer shapes (K =
    MM_K, divisor MR_WS, the own raw row of rank 1 of MR_WS, as the producer
    calls it), as bursts in turns: the tensor-core kernel (the route these
    shapes take), the FFMA 16-bit instance (``_route="ffma"``), the f32
    instance on operands cast beforehand, and ``torch.matmul`` of the bf16
    operands (the library call: tensor cores, a bf16 product, no divide and
    no quantize): tc, ffma, f32, library, library, f32, ffma, tc. Then one
    timed call of the kernel and of its plain version in turns. Bound: the
    larger of the bytes (2-byte operands read once, the payload and the f32
    raw row written once) over the memory rate and the operations (a
    multiply and an add a product) over the card's bf16 tensor-core rate;
    the FFMA ceiling (the same operations at the f32 rate) beside it.
    Returns the record of the kernels line (``mlp_in``'s, the first
    shape)."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.utils.device import mem_rate

    rate = mem_rate(name)
    rng = np.random.default_rng(SEED + 3)
    own = (1, MR_WS)
    out = []
    for layer, (din, o) in MM_SHAPES.items():
        x2, g2 = (torch.from_numpy(rng.standard_normal((MM_K, c)).astype(np.float32)).to(dev).bfloat16()
                  for c in (din, o))
        xf, gf = x2.float(), g2.float()

        def kern(x2=x2, g2=g2):
            return codec_cuda.matmul_quantize_chunks(x2, g2, MR_WS, BITS, BUCKET, own_row=own)

        def ffma(x2=x2, g2=g2):
            return codec_cuda.matmul_quantize_chunks(x2, g2, MR_WS, BITS, BUCKET, own_row=own,
                                                     _route="ffma")

        def f32(xf=xf, gf=gf):
            return codec_cuda.matmul_quantize_chunks(xf, gf, MR_WS, BITS, BUCKET, own_row=own,
                                                     _route="ffma")

        def library(x2=x2, g2=g2):
            return torch.matmul(x2.t(), g2)

        def plain(x2=x2, g2=g2):
            return codec_cuda.matmul_quantize_chunks_plain(x2, g2, MR_WS, BITS, BUCKET, own_row=own)

        before = codec_cuda.MM_TC_LAUNCHES["launches"]
        kern()
        assert codec_cuda.MM_TC_LAUNCHES["launches"] == before + 1, "the timed shape left the tensor cores"
        fns = {"kern": kern, "ffma": ffma, "f32": f32, "library": library}
        burst = {k: [] for k in fns}
        for k in ("kern", "ffma", "f32", "library", "library", "f32", "ffma", "kern"):
            burst[k].append(time_burst(fns[k]))
        burst = {k: min(v) for k, v in burst.items()}
        k1 = time_cuda(kern)
        p1 = time_cuda(plain, iters=5)
        l1 = time_cuda(library)
        l2 = time_cuda(library)
        p2 = time_cuda(plain, iters=5)
        k2 = time_cuda(kern)
        n = din * o
        nbytes = 2 * MM_K * (din + o) + n * BITS // 8 + 8 * n // BUCKET + 4 * n // MR_WS
        ops = 2 * MM_K * n
        t_bytes, t_ops = nbytes / rate * 1e3, ops / BF16_RATE * 1e3
        bound, ffma_ceiling = max(t_bytes, t_ops), ops / F32_RATE * 1e3
        tiles = codec_cuda.mm_tc_tiles(din, o)
        r = {"shape": f"{layer} K={MM_K} {din}x{o} bfloat16", "ms": min(k1, k2), "burst_ms": burst["kern"],
             "plain_ms": min(p1, p2), "library_ms": min(l1, l2), "bound_ms": bound,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations", "ffma_bound_ms": ffma_ceiling,
             "ffma_burst_ms": burst["ffma"], "f32_burst_ms": burst["f32"],
             "library_burst_ms": burst["library"], "bytes": nbytes, "tiles": tiles[0] * tiles[1]}
        log(f"  {MM16:27s} {r['shape']}: tensor cores ({r['tiles']} tiles) burst {r['burst_ms']:.4f} ms, "
            f"FFMA 16-bit instance {r['ffma_burst_ms']:.4f} ({r['ffma_burst_ms'] / r['burst_ms']:.1f}x the "
            f"tensor cores' time), FFMA f32 instance on cast operands {r['f32_burst_ms']:.4f}, torch.matmul "
            f"bf16 {r['library_burst_ms']:.4f} ({r['burst_ms'] / r['library_burst_ms']:.1f}x the library); "
            f"per call {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, library {r['library_ms']:.4f}); "
            f"{nbytes} bytes, {ops} operations, bound {bound:.4f} ms by {r['bound_by']} "
            f"({100 * bound / r['burst_ms']:.1f}% of it a burst), FFMA ceiling {ffma_ceiling:.4f} ms")
        out.append(r)
    return out[0]


def time_stochastic(dev, n: int, name: str, per: dict) -> dict:
    """B1, B7a, B3 and B7c under stochastic rounding beside their
    round-to-nearest selves, at the main path's flat slice (the epilogues
    rows=1, then at phase 7's flat-SRA shape): per call in turns
    (nearest, stochastic, plain, plain, stochastic, nearest), then each as a
    burst. The bound is the largest of the bytes over the memory rate, the
    float32 operations over the f32 rate and the Philox's instructions on
    their busiest pipe (:func:`philox_bound_ms` of ``per``). Returns the
    first record of each kernel by name: the times measured here."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.utils.device import mem_rate

    rate = mem_rate(name)
    rng = np.random.default_rng(SEED + 5)
    sd = SR_SEED
    x = torch.from_numpy(fuzz_operand(rng, n, 0)).to(dev)
    words, meta = codec_cuda.quantize_chunks(x, BITS, BUCKET)
    chunks = n // (32 * BUCKET)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tq, te = (codec_cuda._pipe_tc(chunks, codec_cuda.db_tc_cap(k, BITS, BUCKET, chunks=chunks, sms=sms))
              for k in ("quantize", "epilogue"))
    c = n // SRA_WS
    rows = torch.from_numpy(np.stack([fuzz_operand(rng, c, 0) for _ in range(SRA_WS)])).to(dev)
    q = codec_cuda.quantize_batch(rows, BITS, BUCKET)
    w4, m4, raw4 = q.packed.contiguous(), q.meta.contiguous(), rows[1].contiguous()
    te4 = codec_cuda._pipe_tc(c // (32 * BUCKET), codec_cuda.db_tc_cap(
        "epilogue", BITS, BUCKET, chunks=c // (32 * BUCKET), sms=sms))

    def wire(m: int) -> int:
        return m * BITS // 8 + 8 * m // BUCKET

    ep4 = (SRA_WS - 1) * wire(c) + 4 * c + wire(c)
    head = (TAIL_N // (32 * BUCKET)) * 32 * BUCKET
    xt = torch.from_numpy(fuzz_operand(rng, head, 0)).to(dev)
    # (kernel, shape, call with seed (None: round to nearest), plain
    # stochastic call, bytes, f32 operations, values quantized).
    runs = [
        ("codec_quantize", f"n={n}", lambda s: codec_cuda.quantize_chunks(x, BITS, BUCKET, seed=s),
         lambda: codec_cuda.quantize_chunks_plain(x, BITS, BUCKET, seed=sd), 4 * n + wire(n), 8 * n, n),
        ("codec_quantize_db", f"n={n} tc={tq}",
         lambda s: codec_cuda.quantize_chunks_db(x, BITS, BUCKET, tq, seed=s),
         lambda: codec_cuda.quantize_chunks_db_plain(x, BITS, BUCKET, seed=sd), 4 * n + wire(n), 8 * n, n),
        ("codec_sra_epilogue", f"n={n}",
         lambda s: codec_cuda.sra_epilogue_chunks(words[None], meta[None], None, -1, BITS, BUCKET, seed=s),
         lambda: codec_cuda.sra_epilogue_chunks_plain(words[None], meta[None], None, -1, BITS, BUCKET,
                                                      seed=sd), 2 * wire(n), 12 * n, n),
        ("codec_sra_epilogue_db", f"n={n} tc={te}",
         lambda s: codec_cuda.sra_epilogue_chunks_db(words[None], meta[None], None, -1, BITS, BUCKET, te,
                                                     seed=s),
         lambda: codec_cuda.sra_epilogue_chunks_db_plain(words[None], meta[None], None, -1, BITS, BUCKET,
                                                         seed=sd), 2 * wire(n), 12 * n, n),
        ("codec_sra_epilogue", f"ws={SRA_WS} own=1 n={c}",
         lambda s: codec_cuda.sra_epilogue_chunks(w4, m4, raw4, 1, BITS, BUCKET, seed=s),
         lambda: codec_cuda.sra_epilogue_chunks_plain(w4, m4, raw4, 1, BITS, BUCKET, seed=sd),
         ep4, (3 * SRA_WS + 8) * c, c),
        ("codec_sra_epilogue_db", f"ws={SRA_WS} own=1 n={c} tc={te4}",
         lambda s: codec_cuda.sra_epilogue_chunks_db(w4, m4, raw4, 1, BITS, BUCKET, te4, seed=s),
         lambda: codec_cuda.sra_epilogue_chunks_db_plain(w4, m4, raw4, 1, BITS, BUCKET, seed=sd),
         ep4, (3 * SRA_WS + 8) * c, c),
        ("codec_quantize", f"B5: the tail slice's {head // (32 * BUCKET)} chunks, n={head}",
         lambda s: codec_cuda.quantize_chunks(xt, BITS, BUCKET, seed=s),
         lambda: codec_cuda.quantize_chunks_plain(xt, BITS, BUCKET, seed=sd),
         4 * head + wire(head), 8 * head, head),
    ]
    out = {}
    for k, shape, kern, plain, nbytes, ops, values in runs:
        d1 = time_cuda(lambda: kern(None))
        s1 = time_cuda(lambda: kern(sd))
        p1 = time_cuda(plain, iters=5)
        p2 = time_cuda(plain, iters=5)
        s2 = time_cuda(lambda: kern(sd))
        d2 = time_cuda(lambda: kern(None))
        sb = time_burst(lambda: kern(sd))
        db = time_burst(lambda: kern(None))
        t_bytes, t_f32 = nbytes / rate * 1e3, ops / F32_RATE * 1e3
        t_int, pipe = philox_bound_ms(values, per)
        bound = max(t_bytes, t_f32, t_int)
        by = "bytes" if t_bytes >= max(t_f32, t_int) else "operations"
        ms, det_ms = min(s1, s2), min(d1, d2)
        log(f"  {k:21s} stochastic {shape}: {ms:.4f} ms, burst {sb:.4f} ms (round to nearest "
            f"{det_ms:.4f} ms, burst {db:.4f} ms; plain {min(p1, p2):.3f} ms); {nbytes} bytes "
            f"({t_bytes:.4f} ms), Philox {t_int:.4f} ms on the {pipe} pipe; bound {bound:.4f} ms by "
            f"{by} = {100 * bound / ms:.1f}% / {100 * bound / sb:.1f}% of bound (per call / burst)")
        if k not in out:
            out[k] = {"sr_ms": ms, "sr_burst_ms": sb, "sr_plain_ms": min(p1, p2), "det_burst_ms": db}
    return out


def start_philox_sass(lib):
    """:func:`philox_sass` of the built library on a thread of its own,
    beside phases 3 and 4. Returns a function that waits for it, logs and
    returns its result."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(philox_sass, lib)
    pool.shutdown(wait=False)

    def result() -> dict:
        per, lines = fut.result()
        for ln in lines:
            log(ln)
        return per

    return result


def sass_opcodes(lib, pattern) -> tuple:
    """Opcode counts (NOPs left out) of each function of the built library
    whose mangled name ``pattern`` (a compiled regex) matches, keyed by the
    pattern's first group, from ``cuobjdump -sass``: of those functions
    alone (``-fun``, their mangled names from the build's ptxas report)
    where that finds them all, else of the whole library. Returns the
    counts and how they were dumped; raises if cuobjdump fails."""
    import atexit
    import subprocess
    from collections import Counter

    from torch_cgx_tpu_torch.ops import codec_cuda

    tool = os.path.join(os.path.dirname(codec_cuda._nvcc()), "cuobjdump")
    op = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
    names = sorted({m for m in re.findall(r"Compiling entry function '(\w+)'",
                                          str(codec_cuda.BUILD_LOG.get("ptxas", "")))
                    if pattern.search(m)})

    def dump(args) -> tuple:
        counts, cur = {}, None
        proc = subprocess.Popen([tool, "-sass", *args, str(lib)], stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        atexit.register(proc.kill)  # no dump outlives a run that failed
        for line in proc.stdout:
            if "Function :" in line:
                found = pattern.search(line)
                cur = counts.setdefault(found.group(1), Counter()) if found else None
            elif cur is not None:
                m = op.match(line)
                if m and m.group(1) != "NOP":
                    cur[m.group(1)] += 1
        return counts, proc.wait()

    counts, rc, how = {}, None, "the whole library"
    if names:
        counts, rc = dump(["-fun", ",".join(names)])
        how = f"-fun, {len(names)} functions"
    if rc != 0 or len(counts) != len(names):
        counts, rc = dump([])
        how = "the whole library"
    if rc != 0:
        raise RuntimeError(f"cuobjdump failed (rc {rc})")
    return counts, how


def philox_sass(lib) -> tuple:
    """The Philox's instructions a stochastically rounded value by pipe of
    :data:`SASS_PIPES`, from ``cuobjdump -sass`` of the built library
    (:func:`sass_opcodes`): the opcodes of B1's stochastic instance of
    :data:`PHILOX_SASS_KERNEL` less the deterministic one's, over the 32
    values a thread. Returns them and the log lines (the opcodes that
    differ, the time); raises if either instance is missing."""
    t0 = time.perf_counter()
    found, how = sass_opcodes(lib, PHILOX_SASS_KERNEL)
    if set(found) != {"0", "1"}:
        raise RuntimeError(f"cuobjdump found {len(found)} of B1's two instances")
    counts = {k == "1": v for k, v in found.items()}
    diff = {k: counts[True][k] - counts[False][k] for k in set(counts[True]) | set(counts[False])}
    diff = {k: v for k, v in sorted(diff.items(), key=lambda kv: -abs(kv[1])) if v}
    per = {}
    for pipe, (_, ops) in SASS_PIPES.items():
        n = sum(v for k, v in diff.items() if ops is None or k.split(".")[0] in ops)
        per[pipe] = max(n, 0) / 32
    lines = [
        f"  Philox in SASS (B1 <4, div, sum, one position, stochastic> less round to nearest, "
        f"{sum(counts[True].values())} against {sum(counts[False].values())} instructions; "
        f"cuobjdump of {how} {time.perf_counter() - t0:.1f} s): " + ", ".join(f"{k} {v:+d}" for k, v in diff.items()),
        "  Philox a value by pipe: " + ", ".join(
            f"{p} {v:.2f} ({v / SASS_PIPES[p][0]:.4f} SM-clocks)" for p, v in per.items()),
    ]
    return per, lines


def philox_bound_ms(values: int, per: dict) -> tuple:
    """The least time the Philox work of ``values`` stochastically rounded
    values could take on the card: its busiest pipe's count (``per``, from
    :func:`philox_sass`) at that pipe's rate. Returns (ms, pipe)."""
    pipe = max(per, key=lambda p: per[p] / SASS_PIPES[p][0])
    return values * per[pipe] / (SASS_PIPES[pipe][0] * SM_CLOCK_RATE) * 1e3, pipe


def stochastic_step_bounds(rate: float, per: dict) -> dict:
    """The least device time a stochastic step of the world-size-1 proxy
    could take in B1 (with B5) and B3, summed over the step's launch shapes
    (``shapebench.step_slices``): each launch the larger of its bytes at
    ``rate`` and its Philox work (:func:`philox_bound_ms`). Computed from
    shapes."""
    from torch_cgx_tpu_torch.tools import shapebench

    out = {"quantize": [0, 0.0], "epilogue": [0, 0.0]}
    for c, tail in shapebench.step_slices():
        t_int = philox_bound_ms(c * 32 * BUCKET, per)[0]
        kernels = ("quantize",) if tail else ("quantize", "epilogue")
        for k in kernels:
            out[k][0] += 1
            out[k][1] += max(shapebench.shape_bytes(k, c, 1, -1) / rate * 1e3, t_int)
    return {k: {"launches": v[0], "bound_ms": v[1]} for k, v in out.items()}


def shapebench_step_bounds(name: str, dtype_name: str) -> dict:
    """``shapebench.step_bounds`` at the card's memory rate, the parameters
    in ``dtype_name``."""
    from torch_cgx_tpu_torch.tools import shapebench
    from torch_cgx_tpu_torch.utils.device import mem_rate

    return shapebench.step_bounds(mem_rate(name), dtype_name)


def time_steps(sl: dict, iters: int = 5) -> tuple:
    """Train-step milliseconds without the codec (forward, backward, Adam;
    no sync), with it (``make_train_step`` under ``CGX_DEBUG_FORCE_CODEC``)
    on the single-stage kernels (``CGX_PALLAS_DB=off``) and on the pipelined
    ones (``on``), host clock around synchronised steps, in turns: plain,
    off, on, on, off, plain."""
    import torch

    from torch_cgx_tpu_torch.models import lm_loss

    model, tokens, opt, step = sl["model"], sl["tokens"], sl["opt"], sl["step"]

    def plain_step():
        opt.zero_grad(set_to_none=True)
        lm_loss(model(tokens), tokens).backward()
        opt.step()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    def codec_step(db: str):
        def run():
            os.environ["CGX_PALLAS_DB"] = db
            step(tokens)
        return run

    off, on = codec_step("off"), codec_step("on")
    p1, c1, d1, d2, c2, p2 = (timed(f) for f in (plain_step, off, on, on, off, plain_step))
    os.environ["CGX_PALLAS_DB"] = "off"
    return min(p1, p2), min(c1, c2), min(d1, d2), plain_step


def profile_step(name: str, fn) -> dict:
    """Where one step's time goes: ``torch.profiler`` over a warm step
    (``shapebench.profile_codec``), device time by kernel, the codec
    kernels' share and the device's idle share of the step's wall time (the
    profiler's own overhead included)."""
    from torch_cgx_tpu_torch.tools import shapebench

    p = shapebench.profile_codec(fn)
    if not p["busy_ms"]:
        log(f"  profile {name}: the profiler saw no device time (not measured)")
        return p
    log(f"  profile {name}: wall {p['wall_ms']:.2f} ms, device busy {p['busy_ms']:.2f} ms, idle share "
        f"{100 * (1 - p['busy_ms'] / p['wall_ms']):.1f}%; codec kernels {p['codec_ms']:.3f} ms")
    for k, v in p["top"]:
        log(f"    {v:8.3f} ms  {k[:110]}")
    log("    codec: " + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(p["codec_by_kernel"].items())))
    return p


def host_split(runs: dict, iters: int = 5) -> dict:
    """Where the codec's host-clock price in the step goes, for each run of
    ``runs`` (a label -> a slice's run: its model and tokens): from an idle
    card, the host's time to issue the forward and backward, the device's
    backlog when it is done (host clock from there to a synchronise), the
    host's time to issue ``gradient_sync`` (the step's sync) and the sync's
    wall time to a synchronise, medians over ``iters`` after one warm-up;
    then one sync under ``torch.profiler`` (CPU): the aten operations it
    issues and their self CPU time, by operation. Logs each run and the
    operations whose counts differ between the first two runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch_cgx_tpu_torch.models import lm_loss
    from torch_cgx_tpu_torch.parallel import gradient_sync

    out = {}
    for label, r in runs.items():
        model, tokens = r["model"], r["tokens"]
        ts = []
        for _ in range(iters + 1):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_loss(model(tokens), tokens).backward()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            grads = {n: p.grad for n, p in model.named_parameters()}
            t3 = time.perf_counter()
            gradient_sync(grads, average=True)
            t4 = time.perf_counter()
            torch.cuda.synchronize()
            ts.append((t1 - t0, t2 - t1, t4 - t3, time.perf_counter() - t3))
        fb, backlog, s_host, s_wall = (1e3 * statistics.median(col) for col in zip(*ts[1:]))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            gradient_sync(grads, average=True)
            torch.cuda.synchronize()
        ops = {e.key: (e.count, e.self_cpu_time_total / 1e3)
               for e in prof.key_averages() if e.key.startswith("aten::")}
        model.zero_grad(set_to_none=True)
        del grads
        n_ops, self_ms = sum(c for c, _ in ops.values()), sum(t for _, t in ops.values())
        top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:6]
        log(f"  host split, {label}: forward+backward issued in {fb:.2f} ms, device backlog then "
            f"{backlog:.2f} ms; gradient_sync issued in {s_host:.2f} ms, {s_wall:.2f} ms to a "
            f"synchronise from an idle card; under the profiler {n_ops} aten operations, "
            f"{self_ms:.2f} ms self CPU time; largest " + ", ".join(
                f"{k} {c} x {t:.2f} ms" for k, (c, t) in top))
        out[label] = {"fb_ms": fb, "backlog_ms": backlog, "sync_host_ms": s_host,
                      "sync_wall_ms": s_wall, "ops": ops}
    a, b = list(out.values())[:2]
    moved = {k: (a["ops"].get(k, (0, 0.0)), b["ops"].get(k, (0, 0.0)))
             for k in set(a["ops"]) | set(b["ops"])
             if a["ops"].get(k, (0,))[0] != b["ops"].get(k, (0,))[0]}
    log(f"  host split, aten operations whose counts differ ({' vs '.join(list(out)[:2])}): " + (", ".join(
        f"{k} {x[0]} ({x[1]:.2f} ms) vs {y[0]} ({y[1]:.2f} ms)"
        for k, (x, y) in sorted(moved.items(), key=lambda kv: -abs(kv[1][1][1] - kv[1][0][1])))
        or "none"))
    return out


def time_step_shapes(dev, name: str) -> list:
    """B1/B5 and B3 alone at the step's launch shapes, and B4 at phase 7's
    (``shapebench``: cold inputs, back-to-back launches behind a sleep
    kernel, five groups in turns with the plain version); B4's burst time
    and bound a rank-step of each four-rank scheme."""
    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.tools import shapebench
    from torch_cgx_tpu_torch.utils.device import mem_rate

    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = shapebench.time_shapes(codec_cuda, dev, mem_rate(name),
                                 shapes=shapebench.SHAPES + shapebench.REDUCE_SHAPES)
    for r in out:
        if r["kernel"] == "reduce":
            geo = "grid over the values"
        else:
            g = codec_cuda.cluster_geometry(r["chunks"], BUCKET, BITS, sms)
            geo = f"k={g.k} T={g.threads}"
        log(f"  {r['shape']:31s} {geo}: {r['ms']:.4f} ms (groups "
            f"{', '.join(f'{t:.4f}' for t in r['groups_ms'])}; spread {100 * r['spread']:.1f}%), "
            f"plain {r['plain_ms']:.3f} ms; {r['bytes']} bytes, bound {r['bound_ms']:.4f} ms "
            f"= {r['pct_of_bound']:.1f}% of bound")
    counts = shapebench.reduce_step_shapes(dev)
    step_ms = shapebench.reduce_step_ms(out, counts)
    for scheme, b in shapebench.reduce_step_bounds(mem_rate(name), dev).items():
        log(f"  B4 a rank-step, {scheme}: {b['launches']} launches, {step_ms[scheme]:.4f} ms of bursts "
            f"(reduce_step_ms), bound {b['bound_ms']:.4f} ms (reduce_step_bounds, {b['bytes']} bytes)")
    return out


def time_wire16(dev, name: str) -> dict:
    """The 16-bit instances alone (``shapebench.WIRE16_SHAPES``: cold
    inputs, back-to-back launches behind a sleep kernel, two groups in
    turns with the plain version) against their byte bound (2-byte inputs
    and raw rows), and B4's burst time and bound a rank-step of the
    bf16-parameter two-level scheme. Returns each kernel's measured burst
    at the 64 MB bf16 slice (B4: the two-level 1,024 chunks) and that
    shape's label, for the kernels line; its bytes and bound are in the
    log."""
    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.tools import shapebench
    from torch_cgx_tpu_torch.utils.device import mem_rate

    rate = mem_rate(name)
    out = shapebench.time_shapes(codec_cuda, dev, rate, groups=2, shapes=shapebench.WIRE16_SHAPES)
    for r in out:
        log(f"  {r['shape']:40s}: {r['ms']:.4f} ms (groups {', '.join(f'{t:.4f}' for t in r['groups_ms'])}), "
            f"plain {r['plain_ms']:.3f} ms; {r['bytes']} bytes, bound {r['bound_ms']:.4f} ms "
            f"= {r['pct_of_bound']:.1f}% of bound")
    bf16 = [r for r in out if r["dtype"] == "bfloat16"]
    step_ms = shapebench.reduce_step_ms(bf16, shapebench.reduce_step_shapes(dev, "bfloat16"))
    b = shapebench.reduce_step_bounds(rate, dev, "bfloat16")["two_level"]
    log(f"  B4 a rank-step, two-level, bf16 parameters: {b['launches']} launches, "
        f"{step_ms['two_level']:.4f} ms of bursts, bound {b['bound_ms']:.4f} ms ({b['bytes']} bytes)")
    pick = {"codec_quantize": "B1 bfloat16 c=2048", "codec_quantize_db": "B7a bfloat16 c=2048",
            "codec_sra_epilogue": "B3 bfloat16 c=2048 rows=1",
            "codec_sra_epilogue_db": "B7c bfloat16 c=2048 rows=1",
            "codec_reduce_rows": "B4 bfloat16 two-level c=1024 rows=2 own=0"}
    by_shape = {r["shape"]: r for r in out}
    return {k: {"bf16_shape": lab, "bf16_burst_ms": by_shape[lab]["ms"]} for k, lab in pick.items()}


# ---------------------------------------------------------------------------
# Phase 5b: the int8 fold (CGX_SRA_ACCUM=int8).
# ---------------------------------------------------------------------------

INT8_KERNELS = ("codec_sra_epilogue", "codec_sra_epilogue_db", "codec_reduce_rows")
# Buckets with a ws: within the register budget (512, 2,048, 4,096) and
# past it (1,760: no cluster size splits its 55 warps; 6,144 to 16,384),
# the multiples of 128 from 2,048 on past the old epilogue gate (a chunk's
# f32 tile within a block's shared memory, B <= 1,792), each at the largest
# ws the JAX block budget (ws x 32 x B <= 2^20) takes; 1,760 (no multiple
# of 128) reaches the chunk wrappers only.
INT8_BUCKETS = ((512, 8), (1760, 4), (2048, 8), (4096, 8), (6144, 4), (8192, 4), (16384, 2))
# The step's epilogue launch shapes (chunks of bucket 512, one row), and
# the multi-row ones: the four-rank flat SRA's and an eight-rank mlp share.
INT8_STEP_CHUNKS = (108, 144, 307, 480, 1024)
INT8_ROW_SHAPES = ((256, 4, (None, 0, 1, 2, 3)), (18, 8, (None, 3)))
INT8_WIRE16_SHAPES = ((256, 4, 1), (2048, 1, None))


def start_int8_build():
    """Build the int8 library (``codec_cuda.build_int8``) on a thread beside
    phases 3-5, its compilers at niceness 19 so that the phases keep the
    cores they use (beside the default build it slowed that build by a
    third). Returns a function that waits for it and returns the build's
    seconds and the seconds waited."""
    import threading

    from torch_cgx_tpu_torch.ops import codec_cuda

    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            codec_cuda.build_int8(force=True, nice=19)
        except BaseException as e:  # re-raised where the caller waits
            box["error"] = e
        box["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=run, name="int8-build", daemon=True)
    th.start()

    def wait():
        t0 = time.perf_counter()
        th.join()
        if "error" in box:
            raise box["error"]
        return box["seconds"], time.perf_counter() - t0

    return wait


def expected_int8(counts: dict) -> dict:
    """The int8 fold's share of the launches ``counts`` (``LaunchModel``'s,
    the dispatcher's gates as they stand): under ``CGX_SRA_ACCUM=int8``
    every fused epilogue (B3, B7c) and fused reduce (B4) of the reducers,
    else none."""
    from torch_cgx_tpu_torch import config as ccfg

    int8 = ccfg.sra_accum() == "int8"
    return {k: counts[k] if int8 else 0 for k in INT8_KERNELS}


def ptxas_report_int8(ptxas: str) -> None:
    """The int8 library's instances: their count by kernel and element
    type, registers and spills, beside their exact twins' (the default
    build's report)."""
    from torch_cgx_tpu_torch.ops import codec_cuda

    table = codec_cuda.ptxas_instances(ptxas)
    exact = codec_cuda.ptxas_instances(str(codec_cuda.BUILD_LOG.get("ptxas", "")))
    log(f"  int8 library: {len(table)} kernels")
    for kernel in ("cgx_sra_epilogue_cluster_kernel", "cgx_sra_epilogue_db_cluster_kernel",
                   "cgx_reduce_rows_kernel"):
        for wire16 in (False, True):
            mine = {k: v for k, v in table.items()
                    if k.startswith(kernel + "<") and k.endswith(":16") == wire16}
            twins = [exact.get(k.replace(":int8", "")) for k in mine]
            dreg = [v["registers"] - t["registers"] for (k, v), t in zip(mine.items(), twins) if t]
            spill = [v for v in mine.values() if v["spill_stores"] or v["spill_loads"]]
            most = max([v["spill_stores"] for v in spill] or [0])
            log(f"    {kernel} ({'16-bit' if wire16 else 'f32'}): {len(mine)} instances, "
                f"{min(v['registers'] for v in mine.values())}-"
                f"{max(v['registers'] for v in mine.values())} registers a thread "
                f"({min(dreg)}..{max(dreg)} against the exact twins), {len(spill)} with spills "
                f"(at most {most} bytes stored)")
            want = 128 if kernel != "cgx_reduce_rows_kernel" else (16 if wire16 else 32)
            assert len(mine) == want, (kernel, wire16, len(mine))


def check_int8(dev) -> dict:
    """Phase 5b: B3, B7c and B4's int8 instances against the int8 fold's
    plain versions on the card's tensors, bit for bit (tolerance 0): at the
    step's epilogue shapes (one row; the four-rank flat SRA's ws 4 x 256
    chunks with the raw own row in each place; ws 8 x 18), B7c's bytes equal
    to B3's; at bits 1-8 on ``qbench.adversarial_operand`` rows at ws 4,
    round to nearest and stochastic, every lowering at 4 bits; at the
    buckets 512-16,384 of ``INT8_BUCKETS`` (past the register budget and the
    old epilogue gate) through the batch functions and forced; at every
    cluster size of bucket 512, B7c at tiles of one and two chunks and ring
    depths 1-8; in bf16 and f16 (raw row and cast); B4 at phase 7's launch
    shapes (``shapebench.REDUCE_SHAPES``), at rows 1-8 and 11 with the raw
    row first, last and none, f32, bf16 and f16 raw rows, both widths; and
    the world-size-1 epilogue (one row, no raw row) equal to the exact
    fold's bytes. Returns each kernel's largest difference (0)."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.tools import qbench, shapebench

    rng = np.random.default_rng(SEED + 8)
    err = {k: 0.0 for k in INT8_KERNELS}
    n_checks = {k: 0 for k in INT8_KERNELS}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def record(kernel, label, got, want):
        e = _max_abs(got, want) if got.shape == want.shape else float("inf")
        err[kernel] = max(err[kernel], e)
        n_checks[kernel] += 1
        if not _same_bits(got, want):
            raise AssertionError(f"{kernel} int8 {label}: kernel disagrees with its plain version ({e})")

    def epilogues(label, q, raw, own, bits, b, tc=1, **kw):
        """B3 and B7c (at tile tc) against the plain int8 epilogue, on the
        payload ``q`` (its meta upcast, as the batch functions give it)."""
        words, meta = q.packed, q.meta.float()
        pw, pm = codec_cuda.sra_epilogue_chunks_plain(
            words, meta, raw, own, bits, b, kw.get("cast_dtype", torch.float32),
            kw.get("encode"), seed=kw.get("seed"), accum="int8")
        w, m = codec_cuda.sra_epilogue_chunks(words, meta, raw, own, bits, b, accum="int8", **kw)
        record("codec_sra_epilogue", label + " words", w, pw)
        record("codec_sra_epilogue", label + " meta", m, pm)
        w, m = codec_cuda.sra_epilogue_chunks_db(words, meta, raw, own, bits, b, tc, accum="int8", **kw)
        record("codec_sra_epilogue_db", f"{label} tc={tc} words", w, pw)
        record("codec_sra_epilogue_db", f"{label} tc={tc} meta", m, pm)
        return pw, pm

    def rows_of(ws, n, kind=0, dtype=None):
        x = torch.from_numpy(np.stack([fuzz_operand(rng, n, kind) * np.float32(r + 1)
                                       for r in range(ws)])).to(dev)
        return x if dtype is None else x.to(dtype)

    codec_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # The step's epilogue shapes, and the world-size-1 identity.
    for c in INT8_STEP_CHUNKS:
        x = rows_of(1, c * 32 * BUCKET)
        q = codec_cuda.quantize_batch(x, BITS, BUCKET)
        pw, pm = epilogues(f"c={c} rows=1", q, None, -1, BITS, BUCKET)
        ew, em = codec_cuda.sra_epilogue_chunks(q.packed, q.meta, None, -1, BITS, BUCKET, accum="exact")
        if not (_same_bits(ew, pw) and _same_bits(em, pm)):
            raise AssertionError(f"c={c} rows=1: the int8 fold's bytes differ from the exact fold's")
    for c, ws, owns in INT8_ROW_SHAPES:
        x = rows_of(ws, c * 32 * BUCKET)
        q = codec_cuda.quantize_batch(x, BITS, BUCKET)
        for own in owns:
            raw, o = (None, -1) if own is None else (x[own], own)
            epilogues(f"c={c} ws={ws} own={own}", q, raw, o, BITS, BUCKET)
    log(f"  step shapes: B3 and B7c int8 bit-identical to the plain int8 fold at c={INT8_STEP_CHUNKS} "
        f"rows=1 (and there to the exact fold's bytes), (c, ws) {[r[:2] for r in INT8_ROW_SHAPES]}")
    # Every width on adversarial rows, both roundings; every lowering.
    for bits in range(1, 9):
        n = 3 * 32 * BUCKET
        x = torch.from_numpy(np.stack([qbench.adversarial_operand(n, BUCKET, bits, seed=bits + r)
                                       for r in range(4)]).astype(np.float32)).to(dev)
        q = codec_cuda.quantize_batch(x, bits, BUCKET)
        for own in (None, 2):
            raw, o = (None, -1) if own is None else (x[own], own)
            for seed in (None, SR_SEED):
                lows = codec_cuda.ENCODES if bits == BITS else ("div",)
                for enc in lows:
                    for pack in (codec_cuda.PACKS if bits == BITS else ("sum",)):
                        epilogues(f"adversarial bits={bits} own={own} {enc}/{pack} seed={seed}", q, raw,
                                  o, bits, BUCKET, encode=enc, pack=pack, seed=seed)
    log("  bits 1-8, adversarial rows at ws 4 (raw row none and 2), both roundings, every lowering "
        "at 4 bits: bit-identical")
    # Buckets past the register budget and the old gate, through the batch
    # functions (the dispatcher's routing) and forced geometries.
    for b, ws in INT8_BUCKETS:
        chunks = 3
        x = rows_of(ws, chunks * 32 * b)
        q = codec_cuda.quantize_batch(x, BITS, b)
        if codec_cuda.supports_reduce(q) != (b % 128 == 0):
            raise AssertionError(f"B={b} ws={ws}: the fused epilogue's gate is not the JAX package's")
        g = codec_cuda.cluster_geometry(chunks, b, BITS, sms)
        for own in (None, ws - 1):
            raw, o = (None, -1) if own is None else (x[own], own)
            pw, pm = epilogues(f"B={b} ws={ws} own={own} k={g.k} T={g.threads} rounds={g.positions}",
                               q, raw, o, BITS, b)
            if b % 128:
                continue
            got = codec_cuda.sra_epilogue_batch(q, raw_row=raw, own_idx=own, accum="int8")
            record("codec_sra_epilogue", f"B={b} batch words", got.packed[0], pw)
            red = codec_cuda.reduce_rows_batch(q, raw_row=raw, own_idx=own, accum="int8")
            record("codec_reduce_rows", f"B={b} ws={ws} own={own} batch", red,
                   codec_cuda.reduce_rows_chunks_plain(q.packed, q.meta, raw, o, BITS, b, "int8"))
        if b == BUCKET:
            pw, pm = codec_cuda.sra_epilogue_chunks_plain(q.packed, q.meta, x[1], 1, BITS, b,
                                                          accum="int8")
            for g in codec_cuda.cluster_geometries(b):
                w, m = codec_cuda._launch_epilogue(q.packed, q.meta, x[1], 1, BITS, b, "div", "sum", g,
                                                   accum="int8")
                record("codec_sra_epilogue", f"B={b} forced k={g.k}", w, pw)
                record("codec_sra_epilogue", f"B={b} forced k={g.k} meta", m, pm)
            dg = codec_cuda.db_geometry(chunks, b, BITS, sms)
            for tc in (1, 3):
                for slots in (1, 2, 4, 8):
                    w, m = codec_cuda._launch_epilogue_db(q.packed, q.meta, x[1], 1, BITS, b, tc, "div",
                                                          "butterfly", dg, slots=slots, accum="int8")
                    record("codec_sra_epilogue_db", f"B={b} tc={tc} slots={slots}", w, pw)
                    record("codec_sra_epilogue_db", f"B={b} tc={tc} slots={slots} meta", m, pm)
        del x, q
    log(f"  buckets {[b for b, _ in INT8_BUCKETS]} (ws {[w for _, w in INT8_BUCKETS]}), the batch "
        f"functions and forced cluster sizes, tiles and ring depths: bit-identical")
    # The 16-bit wire dtypes: raw row and cast.
    for name in WIRE16:
        dtype = getattr(torch, name)
        for c, ws, own in INT8_WIRE16_SHAPES:
            x = rows_of(ws, c * 32 * BUCKET, dtype=dtype)
            q = codec_cuda.quantize_batch(x, BITS, BUCKET)
            raw, o = (None, -1) if own is None else (x[own], own)
            for seed in (None, SR_SEED):
                epilogues(f"{name} c={c} ws={ws} own={own} seed={seed}", q, raw, o, BITS, BUCKET,
                          cast_dtype=dtype, seed=seed)
    log(f"  bf16 and f16 (raw row and cast) at ws 4 x 256 and rows=1 x 2048, both roundings: "
        f"bit-identical")
    # B4: phase 7's shapes and every row count, raw rows of each wire
    # dtype, both widths.
    cases = [(c, rows, [None, 0] if own >= 0 else [None]) for _, _, c, rows, own in shapebench.REDUCE_SHAPES]
    cases += [(3, rows, [None, 0, rows - 1]) for rows in (1, 2, 3, 4, 5, 6, 7, 8, 11)]
    for chunks, rows_n, owns in cases:
        n = chunks * 32 * BUCKET
        x = rows_of(rows_n, n)
        q = codec_cuda.quantize_batch(x, BITS, BUCKET)
        for own in owns:
            for dtype in ((torch.float32,) if own is None else (torch.float32, torch.bfloat16,
                                                                 torch.float16)):
                raw, o = (None, -1) if own is None else (x[own].to(dtype), own)
                want = codec_cuda.reduce_rows_chunks_plain(q.packed, q.meta, raw, o, BITS, BUCKET,
                                                           "int8")
                for vec in (4, 1):
                    got = codec_cuda._launch_reduce(q.packed, q.meta, raw, o, BITS, BUCKET,
                                                    torch.empty(n, device=dev), vec, "int8")
                    record("codec_reduce_rows", f"c={chunks} rows={rows_n} own={own} {dtype} vec={vec}",
                           got, want)
        del x, q
    log("  B4 int8 at the REDUCE_SHAPES and rows 1-8, 11 (raw row first, last, none; f32, bf16, f16), "
        "both widths: bit-identical")
    sync(dev)
    log(f"  int8 checks: {n_checks}; int8 launches {dict(codec_cuda.INT8_LAUNCHES)} "
        f"({time.perf_counter() - t0:.1f} s)")
    for k in INT8_KERNELS:
        if not codec_cuda.INT8_LAUNCHES[k]:
            raise AssertionError(f"{k}: no int8 instance ran")
    return err


def int8_phase(dev, cfg, sl: dict, steps: int) -> dict:
    """Phase 5b: the GPT-2 124M slice under ``CGX_SRA_ACCUM=int8`` through
    the world-size-1 proxy (its fused epilogue at one row, where every
    scale is 2^12): ``steps`` steps from the seed with the counters reset,
    the launches the layout's (``LaunchModel``), every epilogue an int8
    instance (``INT8_LAUNCHES``), losses and parameters bit-identical to
    the exact fold's steps (phase 4's). Returns the run for phase 5's
    profile; ``CGX_SRA_ACCUM`` stays set for the caller to clear."""
    from torch_cgx_tpu_torch.ops import codec_cuda

    os.environ["CGX_SRA_ACCUM"] = "int8"
    model, step = new_run(dev, cfg)
    codec_cuda.reset_launch_counts()
    losses = [float(step(sl["tokens"])) for _ in range(steps)]
    sync(dev)
    launches, int8 = dict(codec_cuda.LAUNCHES), dict(codec_cuda.INT8_LAUNCHES)
    want = {k: v * steps for k, v in sl["expected"].items()}
    same = [n for n, p in model.named_parameters() if _same_bits(p.detach(), sl["params"][n])]
    log(f"  int8 steps: losses {losses}; launches {launches}; int8 instances {int8}; "
        f"{len(same)}/{len(sl['params'])} parameters bit-identical to the exact steps'")
    assert launches == want, (launches, want)
    assert int8 == expected_int8(want) and int8["codec_sra_epilogue"] > 0, int8
    assert losses == sl["losses"] and len(same) == len(sl["params"]), (losses, sl["losses"])
    return {"model": model, "step": step, "tokens": sl["tokens"]}


def time_int8(dev, name: str) -> dict:
    """The int8 instances beside the exact ones, as bursts in turns (exact,
    int8, int8, exact; ``shapebench``'s cold inputs behind a sleep kernel):
    B3 and B7c at one row of the 64 MB slice and at the four-rank flat
    SRA's ws 4 x 256 chunks with the raw own row, B4 at phase 7's launch
    shapes, summed over a rank-step of the two-level and the all-to-all
    scheme. The bound (logged): bytes at the card's rate, the exact fold's
    plus the own row's meta, which the int8 fold reads. Returns, by kernel,
    the measured int8 burst at its first shape and that shape's label."""
    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.tools import shapebench
    from torch_cgx_tpu_torch.utils.device import mem_rate

    import torch

    rate = mem_rate(name)
    flush = torch.empty(shapebench.FLUSH_BYTES // 4, device=dev)
    shapes = [("epilogue", "B3 c=1024 rows=1", 1024, 1, -1), ("epilogue", "B3 c=256 ws=4 own=1", 256, 4, 1),
              ("epilogue_db", "B7c c=1024 rows=1", 1024, 1, -1),
              ("epilogue_db", "B7c c=256 ws=4 own=1", 256, 4, 1)] + list(shapebench.REDUCE_SHAPES)
    out = []
    launches = 32
    for kernel, label, chunks, rows, own in shapes:
        kern, plain = shapebench.shape_calls(codec_cuda, dev, kernel, chunks, rows, own, launches)
        t = {"exact": [], "int8": []}
        for accum in ("exact", "int8", "int8", "exact"):
            os.environ["CGX_SRA_ACCUM"] = accum
            shapebench.burst_ms(kern, launches, flush)  # warm-up, in this fold
            t[accum].append(shapebench.burst_ms(kern, launches, flush))
        os.environ["CGX_SRA_ACCUM"] = "int8"
        p_ms = shapebench.plain_ms(plain)
        del os.environ["CGX_SRA_ACCUM"]
        nbytes = shapebench.shape_bytes(kernel, chunks, rows, own)
        if own >= 0:
            nbytes += 8 * chunks * 32  # the own row's meta
        r = {"kernel": kernel, "shape": label, "chunks": chunks, "rows": rows, "own": own,
             "ms": statistics.median(t["int8"]), "exact_ms": statistics.median(t["exact"]),
             "plain_ms": p_ms, "bytes": nbytes, "bound_ms": nbytes / rate * 1e3}
        out.append(r)
        log(f"  int8 {label:36s}: {r['ms']:.4f} ms ({', '.join(f'{v:.4f}' for v in t['int8'])}), exact "
            f"{r['exact_ms']:.4f} ({', '.join(f'{v:.4f}' for v in t['exact'])}), plain int8 "
            f"{p_ms:.3f} ms; {nbytes} bytes, bound {r['bound_ms']:.4f} ms = "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound (computed)")
        del kern, plain
        torch.cuda.empty_cache()
    counts = shapebench.reduce_step_shapes(dev)
    for fold in ("int8", "exact"):
        key = "ms" if fold == "int8" else "exact_ms"
        step_ms = shapebench.reduce_step_ms([{**r, "ms": r[key]} for r in out], counts)
        log(f"  B4 a rank-step, {fold} fold: two-level {step_ms['two_level']:.4f} ms, all-to-all "
            f"{step_ms['alltoall']:.4f} ms of bursts")
    for scheme, b in shapebench.reduce_step_bounds(rate, dev).items():
        own_meta = sum(k * 8 * c * 32 for (c, rows, own), k in counts[scheme].items() if own >= 0)
        log(f"  B4 int8 a rank-step, {scheme}: bound {(b['bytes'] + own_meta) / rate * 1e3:.4f} ms "
            f"({b['bytes'] + own_meta} bytes; computed)")
    pick = {"codec_sra_epilogue": "B3 c=1024 rows=1", "codec_sra_epilogue_db": "B7c c=1024 rows=1",
            "codec_reduce_rows": "B4 two-level c=512 rows=2 own=0"}
    by = {r["shape"]: r for r in out}
    return {k: {"int8_shape": lab, "int8_burst_ms": by[lab]["ms"]} for k, lab in pick.items()}


# ---------------------------------------------------------------------------
# Phase 7: four ranks on the card.
# ---------------------------------------------------------------------------

# The knobs of each multi-rank configuration; every other CGX_* knob is
# unset. "group" is the two-level group or the flat world; "model" the
# GPT-2 124M the steps train: the default one (bfloat16 activations), a
# float32 one, or one with its parameters cast to bf16 ("bf16p": bf16
# gradients, synced as bf16 groups, B4 reading the two-level scheme's bf16
# raw own rows). The producer's payload is an f32 product, so the flat SRA
# pair trains the float32 model, whose p.grad is that product too. The
# "_int8" configurations fold under CGX_SRA_ACCUM=int8: the two-level
# scheme's intra reduce (B4 with the raw own rows), the all-to-all's (B4
# without), the flat SRA's epilogue (B3) and its pipelined one (B7c).
# "_ef": make_train_step(error_feedback=True), MR_STEPS steps: the flat SRA
# decodes the stage-1 rows it sent (one more B2 a slice), the two-level
# leader scheme mirrors its intra stage 1 (one more B1 and B2 a slice).
# "sra_guard_*": the nonfinite guard under CGX_NONFINITE_GUARD, rank
# GUARD_RANK's loss scaled by NaN at step GUARD_STEP (:func:`guard_run`).
# The planner's model file: written by multirank_phase beside the ranks'
# store before they start (every rank reads the same bytes); the ranks put
# its path in place of this name.
PLANNER_MODEL = "planner-model.json"
PLANNED_AVG_BITS = "3.5"
MR_CONFIGS = {
    "two_level": ({}, "two_level", "bf16"),
    "ring": ({"CGX_INNER_REDUCTION_TYPE": "RING"}, "world", "bf16"),
    "alltoall": ({"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1"}, "world", "bf16"),
    "uncompressed_intra": ({"CGX_INTRA_COMPRESS": "0"}, "two_level", "bf16"),
    "two_level_int8": ({"CGX_SRA_ACCUM": "int8"}, "two_level", "bf16"),
    "alltoall_int8": ({"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1", "CGX_SRA_ACCUM": "int8"}, "world",
                      "bf16"),
    "sra": ({}, "world", "f32"),
    "sra_producer": ({"CGX_PRODUCER_FUSE": "on"}, "world", "f32"),
    "sra_producer_bf16": ({"CGX_PRODUCER_FUSE": "on"}, "world", "bf16"),
    "sra_db": ({"CGX_PALLAS_DB": "on"}, "world", "f32"),
    "sra_int8": ({"CGX_SRA_ACCUM": "int8"}, "world", "f32"),
    "sra_db_int8": ({"CGX_PALLAS_DB": "on", "CGX_SRA_ACCUM": "int8"}, "world", "f32"),
    "sra_ef": ({}, "world", "f32"),
    "sra_guard_skip": ({"CGX_NONFINITE_GUARD": "skip"}, "world", "f32"),
    "sra_guard_exact": ({"CGX_NONFINITE_GUARD": "exact"}, "world", "f32"),
    # The pipelined SRA (CGX_SCHEDULE=on, CGX_SCHED_CHUNKS unset: 4 blocks)
    # on a float32 model fresh from the seed ("f32s"): after MR_STEPS steps
    # its parameters must equal sra's after its MR_STEPS steps on every
    # rank; then error feedback and producer fusion under it, one step each.
    "sra_sched": ({"CGX_SCHEDULE": "on"}, "world", "f32s"),
    "sra_sched_ef": ({"CGX_SCHEDULE": "on"}, "world", "f32s"),
    "sra_producer_sched": ({"CGX_PRODUCER_FUSE": "on", "CGX_SCHEDULE": "on"}, "world", "f32s"),
    # The step planner (CGX_PLANNER=on, CGX_SCHEDULE unset): "sra_planned"
    # under the default model on a float32 model fresh from the seed
    # ("f32p"), whose parameters and losses after MR_STEPS steps must equal
    # sra's; then on that model one step each: a 3.5-bit budget under the
    # model file the parent wrote from the autotune sweep (PLANNER_MODEL),
    # and producer fusion under the planner, without and with the budget.
    "sra_planned": ({"CGX_PLANNER": "on"}, "world", "f32p"),
    "sra_planned_bits": ({"CGX_PLANNER": "on", "CGX_PLANNER_AVG_BITS": PLANNED_AVG_BITS,
                          "CGX_PLANNER_MODEL": PLANNER_MODEL}, "world", "f32p"),
    "sra_planned_producer": ({"CGX_PLANNER": "on", "CGX_PRODUCER_FUSE": "on"}, "world", "f32p"),
    "sra_planned_producer_bits": ({"CGX_PLANNER": "on", "CGX_PRODUCER_FUSE": "on",
                                   "CGX_PLANNER_AVG_BITS": PLANNED_AVG_BITS,
                                   "CGX_PLANNER_MODEL": PLANNER_MODEL}, "world", "f32p"),
    "two_level_ef": ({}, "two_level", "bf16"),
    "two_level_bf16p": ({}, "two_level", "bf16p"),
    "alltoall_bf16p": ({"CGX_DEBUG_ALL_TO_ALL_REDUCTION": "1"}, "world", "bf16p"),
}
MR_MULTISTEP = ("two_level", "sra", "sra_ef", "two_level_ef", "sra_sched",
                "sra_planned")  # MR_STEPS steps; the rest one
MR_PROFILED = ("sra", "sra_ef", "two_level", "two_level_ef", "sra_producer",
               "sra_producer_bf16", "sra_sched", "sra_planned")  # one profiled step on rank 0
GUARD_RANK, GUARD_STEP = 2, 1
PRODUCED_LAYERS = 12 * len(MM_SHAPES)  # 36 payloads a rank and step
PROJ_LAYERS = 12  # attn_proj: below CGX_STANDALONE_LAYER_ELEMS, in the fused group


def producer_check(model, loss_fn, tokens) -> dict:
    """One backward of ``model`` with producer fusion engaged over the flat
    world. A float32 model: each staged payload against the dispatcher's
    quantize of the exact product (float64, rounded once) of the operands
    its layer's backward handed the kernel, ``/ MR_WS``, held to
    ``payload_close``'s tolerance, and that product within RAW_RTOL of the
    layer's ``p.grad`` (the rows the allreduce would otherwise quantize,
    from the same backward) relative to its largest magnitude; the
    payload's distance from the quantize of ``p.grad / MR_WS`` is logged
    (``cublas_meta_rel``). A bf16-compute model: the operands each layer's
    backward handed the kernel (``fused_producer._stash``'s) must be bf16,
    and each payload (words, meta, raw row) bit-identical to a direct
    launch of the kernel on them (the tensor-core one at these shapes) and
    within the payload tolerance of the plain version on them
    (``payload_close``; the raw row within RAW_RTOL of its largest
    magnitude plus one unit of bf16)."""
    import torch

    from torch_cgx_tpu_torch.config import default_compression_config
    from torch_cgx_tpu_torch.ops import codec_cuda, dispatch, fused_producer

    operands = {}
    real = fused_producer._stash

    def stash(name, cc, w_shape, w_dtype, x2, g2, dw, *rest):
        operands[name] = (x2, g2)
        return real(name, cc, w_shape, w_dtype, x2, g2, dw, *rest)

    fused_producer.configure(None, divisor=MR_WS, active=True)
    fused_producer.begin_step()
    fused_producer.reset_counts()
    model.zero_grad(set_to_none=True)
    fused_producer._stash = stash
    try:
        loss_fn(model, tokens).backward()
    finally:
        fused_producer._stash = real
    counts = dict(fused_producer.COUNTS)
    cc = default_compression_config()
    own = (fused_producer._CFG["rank"], MR_WS)
    checked, worst_meta, worst_steps, failed, dtypes = 0, 0.0, 0.0, [], set()
    worst_cublas, worst_cublas_exact, worst_grad = 0.0, 0.0, 0.0
    for n, p in model.named_parameters():
        ent = fused_producer.lookup(n, p.grad)
        if ent is None:
            continue
        x2, g2 = operands[n]
        dtypes.add(str(x2.dtype).replace("torch.", ""))
        checked += 1
        if x2.dtype != p.dtype:  # a lower-precision product: the kernel's bytes, near the plain version's
            x2, g2 = x2.contiguous(), g2.contiguous()  # as the producer hands them over
            w, m, raw = codec_cuda.matmul_quantize_chunks(x2, g2, MR_WS, cc.bits, cc.bucket_size,
                                                          own_row=own)
            pw, pm, praw = codec_cuda.matmul_quantize_chunks_plain(x2, g2, MR_WS, cc.bits,
                                                                   cc.bucket_size, own_row=own)
            ok, meta_rel, _, steps = payload_close(w, m, pw, pm, cc.bits, cc.bucket_size)
            worst_meta, worst_steps = max(worst_meta, meta_rel), max(worst_steps, steps)
            r64, p64 = raw.double(), praw.double()
            tol = _ulp16(torch.maximum(r64.abs(), p64.abs()), x2.dtype) + RAW_RTOL * float(p64.abs().max())
            if not (ok and bool(((r64 - p64).abs() <= tol).all())
                    and _same_bits(ent.q.packed.reshape(-1), w) and _same_bits(ent.q.meta.reshape(-1, 2), m)
                    and _same_bits(ent.raw_row, raw)):
                failed.append(n)
            continue
        # The exact product of the operands the backward handed the kernel
        # (float64, rounded once), which must be p.grad's within RAW_RTOL
        # of its largest magnitude (the layer's own operands); the payload
        # against its quantize. cuBLAS's float32 p.grad is no reference at
        # META_RTOL here: on the attn_qkv layers after phase 7's earlier
        # steps its own meta strays past 1e-5 from the exact product's
        # (PERF.md); both distances are logged.
        exact = (x2.double().t() @ g2.double()).reshape(-1)
        grad_rel = float((p.grad.reshape(-1).double() - exact).abs().max() / exact.abs().max())
        want = dispatch.quantize_batch((exact / MR_WS).float().view(MR_WS, -1), cc)
        ok, meta_rel, _, steps = payload_close(
            ent.q.packed, ent.q.meta, want.packed, want.meta, cc.bits, cc.bucket_size
        )
        cub = dispatch.quantize_batch((p.grad.reshape(-1) / MR_WS).view(MR_WS, -1), cc)
        worst_cublas = max(worst_cublas, payload_close(ent.q.packed, ent.q.meta, cub.packed, cub.meta,
                                                       cc.bits, cc.bucket_size)[1])
        worst_cublas_exact = max(worst_cublas_exact, payload_close(cub.packed, cub.meta, want.packed,
                                                                   want.meta, cc.bits, cc.bucket_size)[1])
        worst_meta, worst_steps = max(worst_meta, meta_rel), max(worst_steps, steps)
        worst_grad = max(worst_grad, grad_rel)
        if not ok or grad_rel > RAW_RTOL:
            failed.append(n)
    fused_producer.deconfigure()
    model.zero_grad(set_to_none=True)
    return {"counts": counts, "checked": checked, "failed": failed, "dtypes": sorted(dtypes),
            "meta_rel": worst_meta, "steps": worst_steps, "cublas_meta_rel": worst_cublas,
            "cublas_exact_meta_rel": worst_cublas_exact, "grad_rel": worst_grad,
            "identity_misses": fused_producer.COUNTS["producer_fallback_identity"]}


def producer_sched_check(model, loss_fn, tokens) -> dict:
    """One backward of ``model`` with producer fusion engaged over the flat
    world under ``CGX_SCHEDULE=on``: each staged layer's payload is per
    column block of the schedule's table (no monolithic payload, no B8
    launch), its ``dw`` is kept in ``p.grad``, and each block's payload and
    the raw own row equal the dispatcher's quantize of that block of
    ``p.grad / MR_WS`` bit for bit."""
    import torch

    from torch_cgx_tpu_torch.config import default_compression_config
    from torch_cgx_tpu_torch.ops import codec_cuda, dispatch, fused_producer
    from torch_cgx_tpu_torch.parallel import schedule

    fused_producer.configure(None, divisor=MR_WS, active=True)
    fused_producer.begin_step()
    fused_producer.reset_counts()
    model.zero_grad(set_to_none=True)
    mm = codec_cuda.LAUNCHES["codec_matmul_quantize"]
    loss_fn(model, tokens).backward()
    mm = codec_cuda.LAUNCHES["codec_matmul_quantize"] - mm
    counts = dict(fused_producer.COUNTS)
    cc = default_compression_config()
    own = fused_producer._CFG["rank"]
    checked, failed, depths = 0, [], set()
    for n, p in model.named_parameters():
        ent = fused_producer.lookup(n, p.grad)
        if ent is None:
            continue
        checked += 1
        sched = schedule.compiled_schedule(ent.n, MR_WS, cc)
        xs = (p.grad.reshape(-1).float() / MR_WS).view(MR_WS, -1)
        depths.add(len(ent.q_blocks or ()))
        ok = ent.q is None and sched is not None and ent.table == sched.table and _same_bits(ent.raw_row, xs[own])
        for q, (off, w) in zip(ent.q_blocks or (), ent.table or ()):
            want = dispatch.quantize_batch(xs[:, off : off + w].contiguous(), cc)
            ok = ok and _same_bits(q.packed, want.packed) and _same_bits(q.meta, want.meta)
        if not ok:
            failed.append(n)
    fused_producer.deconfigure()
    model.zero_grad(set_to_none=True)
    return {"counts": counts, "checked": checked, "failed": failed, "depths": sorted(depths), "b8": mm}


def _planned_layout(named_grads):
    """The flat world's layout of ``named_grads`` and the step planner's
    plan of it under the knobs as they stand."""
    from torch_cgx_tpu_torch import config as cfg
    from torch_cgx_tpu_torch.parallel import allreduce, planner

    groups = allreduce._tree_layout(allreduce.sorted_items(named_grads), False).groups
    return groups, planner.plan_for_layout(groups, MR_WS, reduction=cfg.intra_reduction())


def plan_record(named_grads) -> dict:
    """The plan a step of ``named_grads`` runs under: each compressed
    slice's (group, slice, length, bits, depth), the predicted step and its
    parts, and the model's terms."""
    from torch_cgx_tpu_torch.parallel import planner

    _, plan = _planned_layout(named_grads)
    return {"slices": [(gi, si, d.n, d.bits, d.chunks) for gi, g in enumerate(plan.decisions)
                       for si, d in enumerate(g) if d.bits <= 8],
            "predicted_s": plan.predicted_s, "components": dict(plan.pred_components),
            "model": planner.cost_model().as_dict()}


def planned_producer_moves(named_grads, dense_k) -> dict:
    """Of the layers whose backward stages a payload
    (``fused_producer.decide``), those the plan moved: its width differs
    from the layer's config (``bits``), or at the same width its depth
    differs from the producer's own one-slice view (``depth``); the sync
    falls back (``plan``) for exactly these."""
    from torch_cgx_tpu_torch.ops import fused_producer
    from torch_cgx_tpu_torch.parallel import allreduce

    groups, plan = _planned_layout(named_grads)
    pl = allreduce.sorted_items(named_grads)
    out = {"bits": [], "depth": [], "staged": 0}
    for gi, g in enumerate(groups):
        path, leaf = pl[g.indices[0]]
        if len(g.indices) != 1 or path not in dense_k or not g.cc.enabled:
            continue
        if fused_producer.decide(path, tuple(leaf.shape), dense_k[path], MR_WS)[0] is None:
            continue
        out["staged"] += 1
        dec = plan.decisions[gi][0]
        n = leaf.numel()
        if dec.bits != g.cc.bits:
            out["bits"].append(path)
        elif fused_producer._schedule_table(g.cc, MR_WS, n) != fused_producer._schedule_table(
                g.cc, MR_WS, n, dec):
            out["depth"].append(path)
    return out


def planned_width_checks(named_grads, dev) -> list:
    """For the smallest planned slice of each width: its values reduced by
    ``allreduce_flat`` over the flat world at its decision (depth and bits)
    on the card, and by the plain versions on the CPU (:func:`_plain_cpu`),
    bit for bit; the card's launches against the :class:`LaunchModel`'s."""
    import torch

    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.parallel import allreduce

    groups, plan = _planned_layout(named_grads)
    pl = allreduce.sorted_items(named_grads)
    best = {}
    for gi, g in enumerate(groups):
        for si, (off, ln) in enumerate(g.slices):
            d = plan.decisions[gi][si]
            if d.bits <= 8 and (d.bits not in best or ln < best[d.bits][2]):
                best[d.bits] = (gi, si, ln, off)
    out = []
    for bits, (gi, si, ln, off) in sorted(best.items()):
        g, dec = groups[gi], plan.decisions[gi][si]
        piece = torch.cat([pl[i][1].reshape(-1) for i in g.indices])[off : off + ln].contiguous()
        model = LaunchModel(dev)
        model.sra(ln, MR_WS, allreduce.planned_config(g.cc, dec), chunks=dec.chunks)
        codec_cuda.reset_launch_counts()
        card = allreduce.allreduce_flat(piece, g.cc, plan=[dec])
        sync(dev)
        launches = dict(codec_cuda.LAUNCHES)
        plain = _plain_cpu(allreduce.allreduce_flat, piece.cpu(), g.cc, plan=[dec])
        out.append({"bits": bits, "n": ln, "chunks": dec.chunks, "group": gi, "same": _same_bits(card.cpu(), plain),
                    "launches": launches, "expected": model.counts})
    return out


def block_copy_ms(named_grads, dev) -> dict:
    """The pipelined SRA's glue copies of one rank-step of ``named_grads``
    over MR_WS ranks: the block copies before each quantize
    (``schedule.block_rows``) and the join of each slice's decoded blocks
    (``schedule.join_blocks``). For each kind: their count, the sum over
    them of one timed call's median (CUDA events, 20 calls, the host's
    launch included: ``ms``) and of a burst's (the copy alone:
    ``burst_ms``), each timed once a distinct shape, and the bytes they
    move (read and written once)."""
    import torch

    from torch_cgx_tpu_torch.parallel import allreduce, schedule

    pl = allreduce.sorted_items(named_grads)
    shapes, tables = {}, {}
    for g in allreduce._group_leaves(pl, compress_small=False):
        if not g.cc.enabled:
            continue
        n = sum(pl[i][1].numel() for i in g.indices)
        for _, ln in allreduce._fusion_slices(n, 4):
            sched = schedule.compiled_schedule(ln, MR_WS, g.cc)
            if sched is None:
                continue
            tables[sched.table] = tables.get(sched.table, 0) + 1
            for _, w in sched.table:
                shapes[(sched.chunk, w)] = shapes.get((sched.chunk, w), 0) + 1
    out = {"copies": sum(shapes.values()), "ms": 0.0, "burst_ms": 0.0, "bytes": 0,
           "joins": sum(tables.values()), "join_ms": 0.0, "join_burst_ms": 0.0, "join_bytes": 0}
    for (chunk, w), count in shapes.items():
        xs = torch.randn(MR_WS, chunk, device=dev)
        out["ms"] += count * time_cuda(lambda: schedule.block_rows(xs, 0, w))
        out["burst_ms"] += count * time_burst(lambda: schedule.block_rows(xs, 0, w))
        out["bytes"] += count * 2 * MR_WS * w * 4
    for table, count in tables.items():
        blocks = [torch.randn(MR_WS, w, device=dev) for _, w in table]
        out["join_ms"] += count * time_cuda(lambda: schedule.join_blocks(blocks))
        out["join_burst_ms"] += count * time_burst(lambda: schedule.join_blocks(blocks))
        out["join_bytes"] += count * 2 * MR_WS * sum(w for _, w in table) * 4
    return out


def _configure(knobs: dict) -> None:
    """Every CGX_* knob unset but the cache directory, then ``knobs``."""
    for k in [k for k in os.environ if k.startswith("CGX_") and k != "CGX_AUTOTUNE_DIR"]:
        del os.environ[k]
    os.environ.update({
        "CGX_COMPRESSION_QUANTIZATION_BITS": str(BITS),
        "CGX_COMPRESSION_BUCKET_SIZE": str(BUCKET),
        **knobs,
    })


def _digests(model) -> dict:
    import torch

    return {n: hashlib.sha256(p.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
            for n, p in model.named_parameters()}


def _plain_cpu(fn, *args, **kw):
    """``fn`` on CPU tensors: the kernels' plain versions, in the fused
    lowering the card takes for every batch that supports it."""
    os.environ["CGX_SRA_EPILOGUE"] = "fused"
    try:
        return fn(*args, **kw)
    finally:
        del os.environ["CGX_SRA_EPILOGUE"]


# Phase 7's DDP configurations: the comm hook (``torch_backend``) under
# DistributedDataParallel on the float32 GPT-2 124M. Registration at step 2,
# so steps 2 and 3 run the per-layer configs; step 3's buckets (after the
# division) are captured and reduced again by the kernels and by the plain
# versions on the CPU, under each (name, knobs, bucket dtype) of the
# configuration's reruns: every bucket under the first, every fourth one
# (HOOK_RERUN_STRIDE) of all but the last under the rest and under the
# ``_sr`` configurations' one rerun (:func:`_rerun_buckets`): of the 13
# buckets, the first and two between. ``ddp_hook`` runs the flat SRA over one host;
# ``ddp_hook_hier`` fakes two hosts of two ranks (CGX_SHM_HOST_ID) under the
# default two-level scheme (intra SRA, cross Ring, leader scheme on). The
# ``_sr`` configurations rerun each under CGX_STOCHASTIC_ROUNDING=1, the
# kernel-vs-plain reruns drawing the same frame keys (:func:`_seed_state`).
# Each configuration gathers its host map anew (``backend.release``), so
# ``ddp_hook_hier_sr`` takes again, after the one-host ``ddp_hook_sr``, the
# two-level subgroups that ``ddp_hook_hier`` formed.
HOOK_STEPS = 4
HOOK_CAPTURE_STEP = 3
HOOK_RERUN_STRIDE = 4
HOOK_INT8_RERUN = "SRA float32 CGX_SRA_ACCUM=int8"
# The CGX_SCHEDULE=on reruns, by configuration, and the rerun whose bucket
# bytes each must equal.
HOOK_SCHED_RERUNS = {"ddp_hook": "SRA float32 scheduled", "ddp_hook_hier": "cross SRA float32 scheduled"}
# The CGX_PLANNER=on rerun: the pipelined bucket SRA at the planner's depth
# (planner.bridge_chunks, the default model), on the scheduled rerun's
# buckets; its bytes too must equal SRA float32's.
HOOK_PLANNED_RERUN = "SRA float32 planned"
HOOK_SCHED_OF = {"SRA float32 scheduled": "SRA float32", "cross SRA float32 scheduled": "cross SRA float32",
                 HOOK_PLANNED_RERUN: "SRA float32"}
HOOK_SCHED_DEPTH = 4  # CGX_SCHED_CHUNKS unset: the sub-chunks of a pipelined SRA
HOOK_CONFIGS = {
    "ddp_hook": (lambda rank: {"CGX_INNER_REDUCTION_TYPE": "SRA"}, (
        ("SRA float32", {"CGX_INNER_REDUCTION_TYPE": "SRA"}, "float32"),
        ("SRA bfloat16", {"CGX_INNER_REDUCTION_TYPE": "SRA"}, "bfloat16"),
        ("ALLTOALL float32", {"CGX_INNER_REDUCTION_TYPE": "ALLTOALL"}, "float32"),
        # The hook folds exactly whatever CGX_SRA_ACCUM says, as the JAX
        # hook's numpy fold: its buckets' bytes are SRA float32's.
        (HOOK_INT8_RERUN, {"CGX_INNER_REDUCTION_TYPE": "SRA", "CGX_SRA_ACCUM": "int8"}, "float32"),
        # The pipelined bucket SRA: its buckets' bytes are SRA float32's
        # (every sub-chunk boundary of GPT-2's buckets lies on its
        # segment's bucket grid).
        (HOOK_SCHED_RERUNS["ddp_hook"], {"CGX_INNER_REDUCTION_TYPE": "SRA", "CGX_SCHEDULE": "on"},
         "float32"),
        (HOOK_PLANNED_RERUN, {"CGX_INNER_REDUCTION_TYPE": "SRA", "CGX_PLANNER": "on"}, "float32"),
    )),
    # The cross SRA and cross all-to-all reruns put B3 and B4 inside the
    # leaders' stage, CGX_INTRA_COMPRESS=0 the raw intra frames.
    "ddp_hook_hier": (lambda rank: {"CGX_SHM_HOST_ID": f"testhost{rank // MR_INTRA}"}, (
        ("default scheme float32", {}, "float32"),
        ("cross SRA float32", {"CGX_CROSS_REDUCTION_TYPE": "SRA"}, "float32"),
        ("cross ALLTOALL float32", {"CGX_CROSS_REDUCTION_TYPE": "ALLTOALL"}, "float32"),
        ("CGX_INTRA_COMPRESS=0 float32", {"CGX_INTRA_COMPRESS": "0"}, "float32"),
        # The leaders' cross SRA pipelined: its bytes are cross SRA's.
        (HOOK_SCHED_RERUNS["ddp_hook_hier"], {"CGX_CROSS_REDUCTION_TYPE": "SRA", "CGX_SCHEDULE": "on"},
         "float32"),
    )),
    "ddp_hook_sr": (lambda rank: {"CGX_INNER_REDUCTION_TYPE": "SRA", "CGX_STOCHASTIC_ROUNDING": "1"}, (
        ("SRA float32 stochastic", {}, "float32"),
    )),
    "ddp_hook_hier_sr": (lambda rank: {"CGX_SHM_HOST_ID": f"testhost{rank // MR_INTRA}",
                                       "CGX_STOCHASTIC_ROUNDING": "1"}, (
        ("default scheme float32 stochastic", {}, "float32"),
    )),
}


def _all_buckets(name: str, ri: int) -> bool:
    """Whether rerun ``ri`` of the DDP configuration ``name`` reduces every
    captured bucket again (the first rerun, but under stochastic rounding,
    which repeats the first two configurations' paths)."""
    return ri == 0 and not name.endswith("_sr")


def _rerun_buckets(items: list, name: str, ri: int) -> list:
    """Of the captured buckets (or anything listed a bucket), those rerun
    ``ri`` of the DDP configuration ``name`` reduces again: all under
    :func:`_all_buckets`, else every HOOK_RERUN_STRIDE-th of all but the
    last. The last holds ``wte`` and its partial bucket, nearly two thirds
    of the rerun values; the configuration's first rerun covers it (the
    ``_sr`` ones rerun the first two configurations' paths): the script's
    time."""
    return items if _all_buckets(name, ri) else items[:-1][::HOOK_RERUN_STRIDE]


def _seed_state(backend, state=None):
    """The DDP hook's frame-seed generators and collective counts (``state``
    None: returned), or put back as ``state`` holds them, so that
    a bucket reduced through the kernels and again through the plain
    versions draws the same frame keys."""
    if state is None:
        return ({k: g.bit_generator.state for k, g in backend._RNGS.items()}, dict(backend._SEQ),
                dict(backend._QSEQ))
    for k, st in state[0].items():
        backend._RNGS[k].bit_generator.state = st
    for counts, saved in ((backend._SEQ, state[1]), (backend._QSEQ, state[2])):
        counts.clear()
        counts.update(saved)


def expected_hook_launches(calls, ws: int, me: int, dev, hosts=None) -> dict:
    """Launches of the hook's bucket allreduces ``calls`` (bucket key,
    values) on rank ``me``, from the registry's layers of each bucket
    (``backend._extract_layers``), the group's host keys and the
    dispatcher's gates."""
    from torch_cgx_tpu_torch import config as cfg
    from torch_cgx_tpu_torch.torch_backend import backend

    model = LaunchModel(dev, cfg.stochastic_rounding())
    for key, numel in calls:
        model.hook(backend._extract_layers(numel, key), ws, me, cfg.intra_reduction(), hosts)
    return model.counts


def ddp_hook_rank(rank: int, dev, gcfg, tokens, loss_fn, name: str) -> dict:
    """One rank of the DDP configuration ``name`` of HOOK_CONFIGS: DDP with
    ``CGXState(None, {"bits": 4, "bucket_size": 512})`` and ``cgx_hook``
    over the gloo world, HOOK_STEPS steps of Adam under the configuration's
    knobs, the world's host map gathered anew. The bucket allreduce (run by
    the group's worker thread) is wrapped to record each call's bucket, its
    thread and at the capture step a copy of its divided buffer; the launch
    counters run over the steps after registration. Under the two-level
    scheme a leader records the digest of each stage-3 frame it sends. Then
    the captured buckets are reduced again through the kernels and through
    the plain versions on the CPU, under each of the configuration's
    reruns."""
    import threading

    import torch
    import torch.distributed as dist

    from torch_cgx_tpu_torch import config as ccfg
    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.parallel import planner
    from torch_cgx_tpu_torch.tools.hookprof import ddp_setup
    from torch_cgx_tpu_torch.torch_backend import backend
    from torch_cgx_tpu_torch.torch_backend.hooks import REGISTRATION_STEP

    t_cfg = time.perf_counter()
    knobs, reruns_of = HOOK_CONFIGS[name]
    knobs = knobs(rank)
    _configure(knobs)
    backend.release(None)  # the host map is gathered under this configuration's knobs
    ccfg.clear_registry()
    model, ddp, state, opt = ddp_setup(dev, gcfg, SEED)
    calls, captured, capture, threads = [], [], [False], set()
    inner = backend.allreduce
    inner_req, inner_hier = backend._requantize_frames, backend._qreduce_hier
    stage3, last = [], [None]

    def recording(t, group=None, op=dist.ReduceOp.SUM, bucket_key=None):
        calls.append((bucket_key, t.numel()))
        threads.add(threading.current_thread().name)
        if capture[0]:
            captured.append((bucket_key, t.detach().clone()))
        return inner(t, group, op, bucket_key=bucket_key)

    def requantize(*a, **kw):
        last[0] = inner_req(*a, **kw)
        return last[0]

    def hier(fused, layers, wdt, topo, hm, *rest):
        last[0] = None
        inner_hier(fused, layers, wdt, topo, hm, *rest)
        if dist.get_rank(hm.intra) == 0:  # the leader's stage-3 frame is its last requantize
            stage3.append(hashlib.sha256(last[0].cpu().numpy().tobytes()).hexdigest())

    backend.allreduce = recording
    backend._requantize_frames, backend._qreduce_hier = requantize, hier
    losses, digests, digest_s = [], [], 0.0
    try:
        for step in range(HOOK_STEPS):
            if step == REGISTRATION_STEP:
                sync(dev)
                codec_cuda.reset_launch_counts()
                calls.clear()
                t0 = time.perf_counter()
                digest_s = 0.0
            capture[0] = step == HOOK_CAPTURE_STEP
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(ddp, tokens)
            loss.backward()
            opt.step()
            losses.append(float(loss))
            t_d = time.perf_counter()
            digests.append(_digests(model))
            digest_s += time.perf_counter() - t_d
        sync(dev)
        hook_s = (time.perf_counter() - t0) / (HOOK_STEPS - REGISTRATION_STEP)
        digest_s /= HOOK_STEPS - REGISTRATION_STEP
        launches = dict(codec_cuda.LAUNCHES)
    finally:
        backend.allreduce = inner
        backend._requantize_frames, backend._qreduce_hier = inner_req, inner_hier
    topo = ccfg.topology_from_env()
    hosts = backend._hosts(None).hosts
    expected = expected_hook_launches(calls, MR_WS, rank, dev, hosts)
    registered = sorted(
        (n, ccfg.get_layer_config((b, i)).bits)
        for b in ccfg.registered_buckets() for i, n in enumerate(ccfg.registered_layer_sizes(b)))
    want = sorted((p.numel(), BITS if state.should_compress_(p) else 32) for p in model.parameters())
    del ddp, opt, model
    torch.cuda.empty_cache()
    reruns = {}
    for ri, (label, rk, dtype) in enumerate(reruns_of):
        _configure({**knobs, **rk})
        mine = _rerun_buckets(captured, name, ri)
        rr_expected = expected_hook_launches(
            [(key, buf.numel()) for key, buf in mine], MR_WS, rank, dev, hosts)
        t1 = time.perf_counter()
        same, rr_launches, rr_int8, card_digests = 0, {k: 0 for k in codec_cuda.LAUNCHES}, 0, []
        pipelined, card_s, bridge = [], [], []
        real_tables = backend._sched_tables

        def tables(sizes, layers):  # the depth of every SRA that pipelines
            t = real_tables(sizes, layers)
            if t is not None:
                pipelined.append(len(t[0]))
            if ccfg.planner_mode() == "on":  # and the planner's depth for it
                align = math.lcm(*[c.bucket_size for _, _, c in layers])
                bits = next((c.bits for _, _, c in layers if c.enabled), 32)
                bridge.append(planner.bridge_chunks(max(sizes), align, len(sizes), bits, 0))
            return t

        backend._sched_tables = tables
        for key, buf in mine:
            x = buf.to(getattr(torch, dtype))
            seeds = _seed_state(backend)
            codec_cuda.reset_launch_counts()
            sync(dev)
            t_card = time.perf_counter()
            card = inner(x.clone(), bucket_key=key)
            sync(dev)
            card_s.append(time.perf_counter() - t_card)
            for k, v in codec_cuda.LAUNCHES.items():
                rr_launches[k] += v
            rr_int8 += sum(codec_cuda.INT8_LAUNCHES.values())
            card_digests.append(hashlib.sha256(card.cpu().view(torch.uint8).numpy().tobytes()).hexdigest())
            _seed_state(backend, seeds)
            plain = _plain_cpu(inner, x.cpu().clone(), bucket_key=key)  # the reduce writes its input
            same += _same_bits(card.cpu(), plain)
        backend._sched_tables = real_tables
        reruns[label] = {"same": same, "buckets": len(mine), "launches": rr_launches,
                         "pipelined": pipelined, "bridge": bridge, "card_s": card_s,
                         "values": sum(b.numel() for _, b in mine), "int8": rr_int8,
                         "digests": card_digests,
                         "expected": rr_expected, "seconds": time.perf_counter() - t1}
    _configure(knobs)
    return {"losses": losses, "digests": digests, "hook_s": hook_s, "digest_s": digest_s,
            "launches": launches,
            "expected": expected, "calls": len(calls) // (HOOK_STEPS - REGISTRATION_STEP),
            "registered": registered, "want": want, "reruns": reruns,
            "hosts": list(hosts),
            "hier": backend._use_hierarchy(None, topo), "threads": sorted(threads),
            "stage3": stage3, "seconds": time.perf_counter() - t_cfg}


def compressed_slices(named) -> int:
    """The compressed fusion slices of a gradient sync of ``named`` (64 MB
    of float32 values a slice)."""
    from torch_cgx_tpu_torch.parallel import allreduce

    pl = allreduce.sorted_items(named)
    return sum(len(allreduce._fusion_slices(sum(pl[i][1].numel() for i in g.indices), 4))
               for g in allreduce._group_leaves(pl, False) if g.cc.enabled)


def roundtrip_bound(x, rt, ws: int, own: int) -> dict:
    """The residual ``x - rt`` of a fusion slice against half a unit of its
    bucket of the stage-1 wire layout: ``x`` edge-padded to ``(ws, chunk)``
    rows, buckets of ``BUCKET`` restarting at each row (a row's partial
    bucket padded with its last value), ``unit = (max - min) / (2^BITS -
    1)``, plus the decode's rounding (2^-22 of the bucket's magnitude). The
    own row, folded raw, must be exactly 0."""
    import torch

    from torch_cgx_tpu_torch.parallel import chunk_layout

    n = x.numel()
    chunk = chunk_layout(n, ws)[0]
    e = (x.double() - rt.double())
    pad = ws * chunk - n
    xs = torch.cat([x.double(), x[-1:].double().expand(pad)]).view(ws, chunk)
    es = torch.cat([e, torch.zeros(pad, dtype=torch.float64)]).view(ws, chunk)
    nb = -(-chunk // BUCKET)
    bpad = nb * BUCKET - chunk
    xb = torch.cat([xs, xs[:, -1:].expand(ws, bpad)], dim=1).view(ws, nb, BUCKET)
    eb = torch.cat([es, torch.zeros(ws, bpad, dtype=torch.float64)], dim=1).view(ws, nb, BUCKET)
    hi, lo = xb.amax(dim=2, keepdim=True), xb.amin(dim=2, keepdim=True)
    bound = (hi - lo) / ((1 << BITS) - 1) / 2 + 2.0**-22 * torch.maximum(hi.abs(), lo.abs())
    ratio = (eb.abs() / bound.clamp(min=1e-300)).amax()
    return {"nonzero": int((e != 0).sum()), "own_zero": not bool(es[own].any()),
            "within": bool((eb.abs() <= bound).all()), "max_ratio": float(ratio)}


def _adam_state(opt) -> list:
    return [{k: (v.clone() if hasattr(v, "clone") else v) for k, v in st.items()}
            for st in opt.state.values()]


def _same_state(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(torch.equal(x[k], y[k]) if hasattr(x[k], "dtype") else x[k] == y[k]
                                     for k in x)
        for x, y in zip(a, b))


def guard_run(rank: int, mdl, optim, tokens, dev) -> dict:
    """One ``sra_guard_*`` configuration on the flat world: from a snapshot
    of the model and Adam, one step of the unguarded path (built under
    "off"); from the snapshot again, MR_STEPS steps of a step built under
    the configuration's ``CGX_NONFINITE_GUARD``, rank GUARD_RANK's loss
    scaled by NaN at step GUARD_STEP (the batch carries the scale). Returns
    whether step 0 equals the unguarded step bit for bit, whether the
    poisoned step kept the parameters and Adam ("skip") or changed them,
    finite ("exact"), the counter, and the launches over the steps."""
    import copy

    import torch

    from torch_cgx_tpu_torch.models import lm_loss
    from torch_cgx_tpu_torch.ops import codec_cuda, fused_producer
    from torch_cgx_tpu_torch.parallel import grad_sync, make_train_step

    def scaled(m, b):
        return lm_loss(m(b[0]), b[0]) * b[1]

    one, nan = torch.ones((), device=dev), torch.full((), float("nan"), device=dev)
    snap_m = {k: v.detach().clone() for k, v in mdl.state_dict().items()}
    snap_o = copy.deepcopy(optim.state_dict())
    guard = os.environ.pop("CGX_NONFINITE_GUARD")
    make_train_step(mdl, scaled, optim, device=dev)((tokens, one))
    os.environ["CGX_NONFINITE_GUARD"] = guard
    ref = [p.detach().clone() for p in mdl.parameters()]
    mdl.load_state_dict(snap_m)
    optim.load_state_dict(snap_o)
    del snap_m, snap_o
    step = make_train_step(mdl, scaled, optim, device=dev)
    sync(dev)
    grad_sync.reset_counts()
    codec_cuda.reset_launch_counts()
    fused_producer.reset_counts()
    out = {"losses": [], "step_times": []}
    for i in range(MR_STEPS):
        if i == GUARD_STEP:
            pre_p = [p.detach().clone() for p in mdl.parameters()]
            pre_o = _adam_state(optim)
        t0 = time.perf_counter()
        out["losses"].append(float(step((tokens, nan if i == GUARD_STEP and rank == GUARD_RANK else one))))
        sync(dev)
        out["step_times"].append(time.perf_counter() - t0)
        if i == 0:
            out["clean_equals_off"] = all(torch.equal(p, r) for p, r in zip(mdl.parameters(), ref))
            del ref
        if i == GUARD_STEP:
            out["kept_params"] = all(torch.equal(p, q) for p, q in zip(mdl.parameters(), pre_p))
            out["kept_adam"] = _same_state(_adam_state(optim), pre_o)
            out["finite"] = all(bool(torch.isfinite(p).all()) for p in mdl.parameters())
            del pre_p, pre_o
    out["step_s"] = sum(out["step_times"]) / MR_STEPS
    out["count"] = grad_sync.COUNTS["nonfinite_steps"]
    out["steps"] = MR_STEPS - 1  # the poisoned step launches no codec kernel
    return out


def _rank_main(rank: int, store: str, result_q, dev_name: str, size: str, seq: int) -> None:
    """One of phase 7's ranks: a gloo group over the FileStore ``store``,
    the two-level layout, GPT-2 from the seed on ``dev_name`` and the
    rank's own tokens. Puts its results (or its traceback) on ``result_q``
    after the group is destroyed."""
    import torch
    import torch.distributed as dist

    out = {}
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from torch_cgx_tpu_torch.config import default_compression_config
        from torch_cgx_tpu_torch.models import GPT2, Dense, GPT2Config, lm_loss
        from torch_cgx_tpu_torch.ops import codec_cuda, fused_producer
        from torch_cgx_tpu_torch.parallel import (
            allreduce_flat, gradient_sync, hierarchical_groups, make_train_step, planner, schedule,
        )
        from torch_cgx_tpu_torch.tools import shapebench
        from torch_cgx_tpu_torch.tools.hookprof import rank_tokens

        timeout = timedelta(seconds=MR_TIMEOUT_S // 2)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank, world_size=MR_WS, timeout=timeout,
        )
        tl = hierarchical_groups(intra_size=MR_INTRA, timeout=timeout)
        layout = (tl.intra_size, tl.cross_size)
        dev = torch.device(dev_name)
        cfg = getattr(GPT2Config, size)()
        model = GPT2(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
        tokens = torch.from_numpy(rank_tokens(cfg.vocab_size, rank, MR_BATCH, seq, SEED)).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)

        def loss_fn(m, t):
            return lm_loss(m(t), t)

        _configure({})
        loss_fn(model, tokens).backward()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        synced = gradient_sync(grads, group=tl)
        sync(dev)
        plain = _plain_cpu(gradient_sync, {k: v.cpu() for k, v in grads.items()}, group=tl)
        out["sync"] = {
            "params": len(grads), "seconds": time.perf_counter() - t0,
            "mismatched": [k for k in grads if not _same_bits(synced[k].cpu(), plain[k])],
        }
        del synced, plain
        first = grads["wte.embedding"].reshape(-1)[:FLAT_N].contiguous()
        cc = default_compression_config()
        models = {"bf16": (model, opt)}
        # The bf16-parameter configurations' layout: the same gradients in
        # bf16 (64 MB slices of 2-byte values), and a 64 MB bf16 slice of
        # the wte gradient for the kernels-vs-plain check.
        grads16 = {k: v.to(torch.bfloat16) for k, v in grads.items()}
        first16 = grads16["wte.embedding"].reshape(-1)[:FLAT16_N].contiguous()
        model_file = os.path.join(os.path.dirname(store), PLANNER_MODEL)
        for name, (knobs, kind, model_kind) in MR_CONFIGS.items():
            knobs = {k: model_file if v == PLANNER_MODEL else v for k, v in knobs.items()}
            _configure(knobs)
            if model_kind not in models:
                if model_kind in ("bf16p", "f32s", "f32p"):
                    for done in ("f32", "f32s", "f32p"):  # the float32 configurations before are done
                        models.pop(done, None)
                    torch.cuda.empty_cache()
                if model_kind == "bf16p":
                    m32 = GPT2(cfg, device=dev,
                               generator=torch.Generator().manual_seed(SEED)).to(torch.bfloat16)
                else:
                    m32 = GPT2(dataclasses.replace(cfg, dtype=torch.float32), device=dev,
                               generator=torch.Generator().manual_seed(SEED))
                models[model_kind] = (m32, torch.optim.Adam(m32.parameters(), lr=1e-4, eps=1e-8))
            mdl, optim = models[model_kind]
            dense_k = {m.kernel_path: MR_BATCH * seq for m in mdl.modules() if isinstance(m, Dense)}
            dense_dtype = next(m.dtype for m in mdl.modules() if isinstance(m, Dense))
            group = tl if kind == "two_level" else None
            layout_grads = grads16 if model_kind == "bf16p" else grads
            ef = name.endswith("_ef")
            expected = (expected_launches(layout_grads, two_level=layout, roundtrip=ef)
                        if kind == "two_level"
                        else expected_launches(layout_grads, ws=MR_WS, dense_k=dense_k, roundtrip=ef,
                                               dense_dtype=dense_dtype))
            res = {"expected": expected, "expected_int8": expected_int8(expected),
                   "slices": compressed_slices(layout_grads)}
            t_cfg = time.perf_counter()
            if ef:
                # The round trip through the layout, kernels against plain,
                # and the slice's residual against the wire layout's units.
                codec_cuda.reset_launch_counts()
                gpu, gpu_rt = allreduce_flat(first, cc, group=group, return_roundtrip=True)
                res["slice_launches"] = dict(codec_cuda.LAUNCHES)
                res["slice_wire16"] = dict(codec_cuda.WIRE16_LAUNCHES)
                res["slice_int8"] = dict(codec_cuda.INT8_LAUNCHES)
                cpu, cpu_rt = _plain_cpu(allreduce_flat, first.cpu(), cc, group=group,
                                         return_roundtrip=True)
                res["slice_same"] = _same_bits(gpu.cpu(), cpu) and _same_bits(gpu_rt.cpu(), cpu_rt)
                res["slice_n"], res["slice_dtype"] = first.numel(), str(first.dtype)
                ws_rt, own = (MR_INTRA, rank % MR_INTRA) if kind == "two_level" else (MR_WS, rank)
                res["residual"] = roundtrip_bound(first.cpu(), gpu_rt.cpu(), ws_rt, own)
                del gpu, gpu_rt, cpu, cpu_rt
            check = {"ring": first, "alltoall": first, "two_level_bf16p": first16,
                     "alltoall_bf16p": first16}.get(name, first if name.endswith("_int8") else None)
            if check is not None:
                codec_cuda.reset_launch_counts()
                gpu = allreduce_flat(check, cc, group=group)
                res["slice_wire16"] = dict(codec_cuda.WIRE16_LAUNCHES)
                res["slice_int8"] = dict(codec_cuda.INT8_LAUNCHES)
                res["slice_launches"] = dict(codec_cuda.LAUNCHES)
                cpu = _plain_cpu(allreduce_flat, check.cpu(), cc, group=group)
                res["slice_same"] = _same_bits(gpu.cpu(), cpu)
                res["slice_n"] = check.numel()
                res["slice_dtype"] = str(check.dtype)
            if name.startswith("sra_planned"):
                res["plan"] = plan_record(grads)
                res["moved"] = planned_producer_moves(grads, dense_k)
            if name == "sra_planned_bits":
                res["widths"] = planned_width_checks(grads, dev)
            if name == "sra_producer_sched" and rank == 0:
                res["check"] = producer_sched_check(mdl, loss_fn, tokens)
            elif name.startswith("sra_producer") and rank == 0:
                res["check"] = producer_check(mdl, loss_fn, tokens)
            if "CGX_NONFINITE_GUARD" in knobs:
                res.update(guard_run(rank, mdl, optim, tokens, dev))
            else:
                steps = MR_STEPS if name in MR_MULTISTEP else 1
                step = make_train_step(mdl, loss_fn, optim, group=group, device=dev,
                                       error_feedback=ef)
                sync(dev)
                codec_cuda.reset_launch_counts()
                fused_producer.reset_counts()
                schedule.reset_counts()
                planner.reset_counts()
                res["step_times"] = []
                res["losses"] = []
                for _ in range(steps):
                    t0 = time.perf_counter()
                    res["losses"].append(float(step(tokens)))
                    sync(dev)
                    res["step_times"].append(time.perf_counter() - t0)
                res["step_s"] = sum(res["step_times"]) / steps
                res["steps"] = steps
                if name in ("sra", "sra_sched", "sra_planned"):  # the parameters after the same steps from the seed
                    res["step_digests"] = _digests(mdl)
            res["launches"] = dict(codec_cuda.LAUNCHES)
            res["wire16"] = dict(codec_cuda.WIRE16_LAUNCHES)
            res["int8"] = dict(codec_cuda.INT8_LAUNCHES)
            res["reduce_scalar"] = codec_cuda.REDUCE_SCALAR["launches"]
            res["mm_tc"] = codec_cuda.MM_TC_LAUNCHES["launches"]
            res["producer"] = dict(fused_producer.COUNTS)
            res["sched"] = dict(schedule.COUNTS)
            res["planner"] = dict(planner.COUNTS)
            if name == "sra_sched":  # rank 0 times the copies alone: the others wait at a barrier
                dist.barrier()
                if rank == 0:
                    res["copies"] = block_copy_ms(grads, dev)
                dist.barrier()
            if ef:
                e = step.ef_state.e
                res["ef"] = {"n": len(e), "nonzero": sum(int((v != 0).sum()) for v in e.values()),
                             "finite": all(bool(torch.isfinite(v).all()) for v in e.values()),
                             "f32": all(v.dtype == torch.float32 for v in e.values()),
                             "absmax": max(float(v.abs().max()) for v in e.values())}
            if name in MR_PROFILED:  # every rank takes profile_codec's two steps
                if rank == 0:
                    res["profile"] = shapebench.profile_codec(lambda: step(tokens))
                else:
                    step(tokens)
                    step(tokens)
            res["seconds"] = time.perf_counter() - t_cfg
            res["digests"] = _digests(mdl)
            out[name] = res
        models.clear()
        torch.cuda.empty_cache()
        for name in HOOK_CONFIGS:
            out[name] = ddp_hook_rank(rank, dev, cfg, tokens, loss_fn, name)
        from torch_cgx_tpu_torch.torch_backend import backend

        backend.release(None)  # the worker stops within its bounded join
        dist.barrier()
    except Exception:  # reported to the parent, which fails the phase
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result_q.put((rank, out))


def multirank_phase(dev_name: str = "cuda:0", size: str = "small", seq: int = SEQ,
                    smi: str = "", planner_model=None) -> dict:
    """Spawn the ranks, collect their results within ``MR_TIMEOUT_S``, stop
    every process, and hold the results to the phase's checks. ``smi``: the
    card's name and power limit, printed beside the ``ddp_hook`` times.
    ``planner_model``: the step planner's model (``planner.CostModel``)
    written to the ranks' PLANNER_MODEL file before they start; where it is
    None or not calibrated by the autotune cache, the default model's
    stated rates."""
    from torch_cgx_tpu_torch.parallel import planner

    if planner_model is None or "autotune" not in planner_model.source:
        log(f"  the autotune memo held no measured rate ({planner_model and planner_model.source}): the "
            f"planner's model file holds the default model's stated rates")
        planner_model = planner.CostModel.default()
    ctx = mp.get_context("spawn")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        planner_model.save(os.path.join(tmp, PLANNER_MODEL))
        log(f"  the planner's model file for {', '.join(n for n in MR_CONFIGS if PLANNER_MODEL in MR_CONFIGS[n][0].values())}: "
            f"{planner_model.as_dict()}")
        result_q = ctx.Queue()
        procs = [
            ctx.Process(target=_rank_main,
                        args=(r, os.path.join(tmp, "store"), result_q, dev_name, size, seq))
            for r in range(MR_WS)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MR_TIMEOUT_S
        try:
            while len(results) < MR_WS and time.monotonic() < deadline:
                try:
                    r, out = result_q.get(timeout=2.0)
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        break
                    continue
                results[r] = out
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if len(results) < MR_WS:
        codes = [p.exitcode for p in procs]
        raise AssertionError(f"phase 7: only ranks {sorted(results)} reported; exit codes {codes}")
    errors = {r: o["error"] for r, o in results.items() if "error" in o}
    if errors:
        raise AssertionError("phase 7 failed:\n" + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))
    res = [results[r] for r in range(MR_WS)]

    s0 = res[0]["sync"]
    log(f"  two-level sync of one backward's gradients, kernels vs plain CPU: "
        f"{s0['params'] - len(s0['mismatched'])}/{s0['params']} parameters bit-identical "
        f"on rank 0 ({s0['seconds']:.1f} s)")
    for r, o in enumerate(res):
        assert not o["sync"]["mismatched"], (r, o["sync"]["mismatched"][:5])
    for name in MR_CONFIGS:
        c0 = res[0][name]
        log(f"  {name}: launches per rank and step derived from the layout: {c0['expected']}")
        log(f"    losses {c0['losses']}; launches on rank 0 over {c0['steps']} step(s): "
            f"{c0['launches']}; host-clock step {c0['step_s']:.2f} s (gloo, wire through host memory; "
            f"each step {[round(t, 3) for t in c0['step_times']]} s); the configuration "
            f"{c0['seconds']:.1f} s")
        if "slice_same" in c0:
            log(f"    kernels vs plain CPU on a {c0['slice_n']}-value {c0['slice_dtype']} fusion slice: "
                f"{'bit-identical' if all(o[name]['slice_same'] for o in res) else 'DIFFERENT'} on every "
                f"rank; rank 0's launches {({k: v for k, v in c0['slice_launches'].items() if v})}, "
                f"reading a 16-bit operand {({k: v for k, v in c0['slice_wire16'].items() if v})}")
        if name.endswith("_bf16p"):
            log(f"    launches reading a bf16 operand over the step(s) on rank 0: "
                f"{({k: v for k, v in c0['wire16'].items() if v})}")
        if name.endswith("_int8"):
            log(f"    int8 instances over the step(s) on rank 0: {c0['int8']} (the layout's: "
                f"{c0['expected_int8']}); on the slice {({k: v for k, v in c0['slice_int8'].items() if v})}")
        for r, o in enumerate(res):
            c = o[name]
            clean = [x for i, x in enumerate(c["losses"]) if "guard" not in name or i != GUARD_STEP]
            assert np.all(np.isfinite(clean)), (name, r, c["losses"])
            assert np.array_equal(c["losses"], c0["losses"], equal_nan=True), (name, r, c["losses"])
            want = {k: v * c["steps"] for k, v in c["expected"].items()}
            assert c["launches"] == want, (name, r, c["launches"], want)
            want8 = {k: v * c["steps"] for k, v in c["expected_int8"].items()}
            assert c["int8"] == want8, (name, r, c["int8"], want8)
            assert c.get("slice_same", True), (name, r)
            diff = [k for k in c0["digests"] if c["digests"][k] != c0["digests"][k]]
            assert not diff, (name, r, diff[:5])
        log(f"    replicas: all {len(c0['digests'])} parameters bit-identical on the {MR_WS} ranks")
    ef_guard_check(res)
    assert res[0]["two_level"]["launches"]["codec_reduce_rows"] > 0
    assert res[0]["alltoall"]["launches"]["codec_reduce_rows"] > 0
    # The int8 configurations ran their kernel's int8 instance in the steps
    # and on the slice, every other one none.
    for name, kernel in (("two_level_int8", "codec_reduce_rows"), ("alltoall_int8", "codec_reduce_rows"),
                         ("sra_int8", "codec_sra_epilogue"), ("sra_db_int8", "codec_sra_epilogue_db")):
        for r, o in enumerate(res):
            assert o[name]["int8"][kernel] > 0 and o[name]["slice_int8"][kernel] > 0, (name, r, o[name])
    assert not any(sum(o[n]["int8"].values()) for o in res for n in MR_CONFIGS if not n.endswith("_int8"))
    # The bf16-parameter steps: every quantize and every B4 launch with a
    # raw own row (the two-level scheme's intra reduce) reads bf16 itself;
    # the all-to-all's B4 has no raw row. The same held on the 64 MB slice.
    for r, o in enumerate(res):
        tl16, a16 = o["two_level_bf16p"], o["alltoall_bf16p"]
        assert tl16["wire16"]["codec_quantize"] == tl16["launches"]["codec_quantize"] > 0, (r, tl16)
        assert tl16["wire16"]["codec_reduce_rows"] == tl16["launches"]["codec_reduce_rows"] > 0, (r, tl16)
        assert tl16["slice_wire16"]["codec_reduce_rows"] > 0, (r, tl16)
        assert a16["wire16"]["codec_quantize"] == a16["launches"]["codec_quantize"] > 0, (r, a16)
        assert a16["wire16"]["codec_reduce_rows"] == 0 < a16["launches"]["codec_reduce_rows"], (r, a16)
    # Every B4 launch of the steps took the full width: the rows the schemes
    # hand it are whole aligned chunks.
    scalar = {(r, name): o[name]["reduce_scalar"] for r, o in enumerate(res) for name in MR_CONFIGS}
    log(f"  B4 launches at scalar width, every rank and configuration: {sum(scalar.values())}")
    assert not any(scalar.values()), scalar
    # The pipelined flat SRA: B7c folds the four ranks' rows with the raw own
    # row, and only there do pipelined kernels run.
    for name in MR_CONFIGS:
        db = {k: v for k, v in res[0][name]["launches"].items() if k.endswith("_db") and v}
        assert bool(db) == name.startswith("sra_db"), (name, db)
    for k in ("codec_quantize_db", "codec_dequantize_db", "codec_sra_epilogue_db"):
        assert res[0]["sra_db"]["launches"][k] > 0, res[0]["sra_db"]["launches"]

    producer_checks(res)
    sched_checks(res, smi)
    planner_checks(res, smi)
    for name in HOOK_CONFIGS:
        hook_check(res, name, smi)
    launches = dict(res[0]["two_level"]["launches"])
    for k in ("codec_matmul_quantize", "codec_tf32_split"):
        launches[k] = res[0]["sra_producer"]["launches"][k]
    int8 = {"codec_sra_epilogue": res[0]["sra_int8"]["int8"]["codec_sra_epilogue"],
            "codec_sra_epilogue_db": res[0]["sra_db_int8"]["int8"]["codec_sra_epilogue_db"],
            "codec_reduce_rows": res[0]["two_level_int8"]["int8"]["codec_reduce_rows"]}
    return {"launches": launches, "int8_launches": int8, "results": res,
            "mm16_launches": res[0]["sra_producer_bf16"]["mm_tc"]}


def producer_checks(res) -> None:
    """Phase 7's checks of producer fusion, each failing the phase:
    ``sra_producer`` on the float32 model and ``sra_producer_bf16`` on the
    default one (bf16 compute, f32 parameters), and both profiled steps."""
    # Producer fusion: the layout-derived counts trade 36 stage-1 quantizes
    # for 36 matmul-quantizes, every rank consumed the 36 payloads, and the
    # only fallbacks are the attn_proj layers, which stay in the fused group
    # (as in the JAX package).
    plain_sra, prod = res[0]["sra"]["expected"], res[0]["sra_producer"]["expected"]
    assert plain_sra["codec_matmul_quantize"] == plain_sra["codec_tf32_split"] == 0, plain_sra
    assert prod["codec_matmul_quantize"] == prod["codec_tf32_split"] == PRODUCED_LAYERS, prod
    assert plain_sra["codec_quantize"] - prod["codec_quantize"] == PRODUCED_LAYERS, (plain_sra, prod)
    for r, o in enumerate(res):
        pc = o["sra_producer"]["producer"]
        assert pc["producer_consumed_slices"] == PRODUCED_LAYERS, (r, pc)
        assert pc["producer_kernel_slices"] == PRODUCED_LAYERS, (r, pc)
        # The step skipped the plain dw of every consumed layer (C4).
        assert pc["producer_dw_skipped"] == PRODUCED_LAYERS, (r, pc)
        assert o["sra_producer"]["launches"]["codec_matmul_quantize"] == PRODUCED_LAYERS, (r, o)
        # float32 operands: every launch on the tensor cores, after its split pass.
        assert o["sra_producer"]["mm_tc"] == PRODUCED_LAYERS, (r, o["sra_producer"]["mm_tc"])
        assert o["sra_producer"]["launches"]["codec_tf32_split"] == PRODUCED_LAYERS, (r, o)
        assert pc["producer_fallbacks"] == pc["producer_fallback_fused_group"] == PROJ_LAYERS, (r, pc)
    chk = res[0]["sra_producer"]["check"]
    log(f"  sra_producer: {res[0]['sra_producer']['launches']['codec_matmul_quantize']} B8 launches a rank on "
        f"float32 operands, on the tensor cores {[o['sra_producer']['mm_tc'] for o in res]} by rank, split "
        f"passes {[o['sra_producer']['launches']['codec_tf32_split'] for o in res]}, dw skipped "
        f"{[o['sra_producer']['producer']['producer_dw_skipped'] for o in res]}")
    log(f"  sra_producer, rank 0: {chk['checked']} staged payloads against a quantize of the exact "
        f"product / {MR_WS}: meta within {chk['meta_rel']:.2e} relative, decoded within "
        f"{chk['steps']:.3f} level steps; {len(chk['failed'])} outside the tolerance; p.grad within "
        f"{chk['grad_rel']:.2e} of the exact product (of its largest magnitude); against a quantize of "
        f"p.grad / {MR_WS} (cuBLAS, not gated) meta within {chk['cublas_meta_rel']:.2e}, that quantize's "
        f"own meta within {chk['cublas_exact_meta_rel']:.2e} of the exact product's; "
        f"backward counters {({k: v for k, v in chk['counts'].items() if v})}")
    for name in ("sra_producer", "sra_producer_bf16"):
        chk = res[0][name]["check"]
        assert chk["checked"] == PRODUCED_LAYERS and not chk["failed"], (name, chk)
        assert chk["identity_misses"] == 0, (name, chk)
        assert chk["counts"]["producer_kernel_slices"] == PRODUCED_LAYERS, (name, chk)
        assert chk["counts"]["producer_fallbacks"] == chk["counts"]["producer_fallback_fused_group"], chk
    # The default model (bf16 compute, f32 parameters): the same layout and
    # launches as the float32 model's but the split passes, every B8 launch
    # on bf16 operands read by the tensor-core kernel (no upcast), every
    # consumed layer's dw skipped.
    assert res[0]["sra_producer_bf16"]["expected"] == dict(prod, codec_tf32_split=0), (
        res[0]["sra_producer_bf16"]["expected"], prod)
    for r, o in enumerate(res):
        c = o["sra_producer_bf16"]
        pc = c["producer"]
        assert (pc["producer_consumed_slices"] == pc["producer_kernel_slices"] == pc["producer_dw_skipped"]
                == PRODUCED_LAYERS), (r, pc)
        assert c["launches"]["codec_matmul_quantize"] == c["wire16"]["codec_matmul_quantize"] == PRODUCED_LAYERS, (r, c)
        assert c["mm_tc"] == PRODUCED_LAYERS, (r, c["mm_tc"])
        assert pc["producer_fallbacks"] == pc["producer_fallback_fused_group"] == PROJ_LAYERS, (r, pc)
    chk = res[0]["sra_producer_bf16"]["check"]
    c0 = res[0]["sra_producer_bf16"]
    log(f"  sra_producer_bf16: {c0['launches']['codec_matmul_quantize']} B8 launches a rank, "
        f"{c0['wire16']['codec_matmul_quantize']} of them on 16-bit operands, on the tensor cores "
        f"{[o['sra_producer_bf16']['mm_tc'] for o in res]} by rank, dw skipped "
        f"{[o['sra_producer_bf16']['producer']['producer_dw_skipped'] for o in res]} by rank; rank 0: "
        f"{chk['checked']} staged payloads on {chk['dtypes']} operands, each bit-identical to a "
        f"direct launch on its operands and within the payload tolerance of the plain version (meta "
        f"within {chk['meta_rel']:.2e} relative, decoded within {chk['steps']:.3f} level steps, raw "
        f"row within RAW_RTOL + one unit of bf16): {chk['checked'] - len(chk['failed'])}")
    assert chk["dtypes"] == ["bfloat16"], chk
    for name in ("sra", "sra_producer", "sra_producer_bf16"):
        p = res[0][name].get("profile", {})
        by = p.get("codec_by_kernel", {})
        mm = sum(by.get(k, 0.0) for k in ("cgx_matmul_quantize_kernel", "cgx_matmul_quantize_tc_kernel",
                                          "cgx_matmul_quantize_tf32_kernel", "cgx_tf32_split_kernel"))
        log(f"  {name}, rank 0's profiled step: B8 {mm:.3f} ms (of it the split pass "
            f"{by.get('cgx_tf32_split_kernel', 0.0):.3f}), codec kernels {p.get('codec_ms', 0.0):.3f} ms "
            f"({', '.join(f'{k} {v:.3f}' for k, v in sorted(p.get('codec_by_kernel', {}).items()))}), device "
            f"busy {p.get('busy_ms', 0.0):.2f} ms of {p.get('wall_ms', 0.0):.1f} ms; largest device entries: "
            + "; ".join(f"{k[:50]} {v:.3f}" for k, v in p.get("top", [])[:5]))


def sched_checks(res, smi: str) -> None:
    """Phase 7's checks of the pipelined SRA (CGX_SCHEDULE=on), each
    failing the phase: ``sra_sched``'s parameters and losses after its
    MR_STEPS steps from the seed equal ``sra``'s on every rank, every
    compressed slice pipelined in four blocks; ``sra_sched_ef``'s round
    trip adds one B2 a block (of a whole chunk or more), its 64 MB slice
    (card against plain CPU) and
    residuals as ``sra_ef``'s checks hold them; ``sra_producer_sched``
    consumed the per-block payloads of every produced layer, kept its
    ``dw`` and launched no B8, its launches those of ``sra_sched``. Logs the
    launches, the block copies and rank 0's profiles beside ``sra``'s."""
    base, sched = res[0]["sra"], res[0]["sra_sched"]
    slices = sched["slices"]
    for r, o in enumerate(res):
        c = o["sra_sched"]
        diff = [k for k in c["step_digests"] if c["step_digests"][k] != o["sra"]["step_digests"][k]]
        assert not diff, ("sra_sched against sra", r, diff[:5])
        assert c["losses"] == o["sra"]["losses"], (r, c["losses"], o["sra"]["losses"])
        assert c["sched"]["pipelined_slices"] == slices * c["steps"], (r, c["sched"])
        assert c["sched"]["blocks"] == 4 * c["sched"]["pipelined_slices"], (r, c["sched"])
        assert c["sched"]["block_copies"] == c["sched"]["blocks"], (r, c["sched"])
        assert c["sched"]["join_copies"] == c["sched"]["pipelined_slices"], (r, c["sched"])
        assert o["sra"]["sched"]["pipelined_slices"] == 0, (r, o["sra"]["sched"])
    ef = res[0]["sra_sched_ef"]
    rt_b2 = ef["expected"]["codec_dequantize"] - sched["expected"]["codec_dequantize"]
    assert ef["expected"] == dict(sched["expected"], codec_dequantize=ef["expected"]["codec_dequantize"])
    assert 0 < rt_b2 <= 4 * slices, (rt_b2, slices)  # one B2 a block that holds a whole chunk
    for r, o in enumerate(res):
        c = o["sra_sched_ef"]
        rb, e = c["residual"], c["ef"]
        assert c["slice_same"] and rb["within"] and rb["own_zero"] and rb["nonzero"] > 0, (r, rb)
        assert e["nonzero"] > 0 and e["finite"] and e["f32"], (r, e)
        assert c["sched"]["pipelined_slices"] == slices, (r, c["sched"])
        assert c["sched"]["join_copies"] == 2 * slices, (r, c["sched"])  # the round trip's too
    prod = res[0]["sra_producer_sched"]
    assert prod["expected"] == sched["expected"], (prod["expected"], sched["expected"])
    for r, o in enumerate(res):
        c = o["sra_producer_sched"]
        pc = c["producer"]
        assert pc["producer_consumed_slices"] == pc["producer_staged"] == PRODUCED_LAYERS, (r, pc)
        assert pc["producer_dw_skipped"] == pc["producer_kernel_slices"] == 0, (r, pc)
        assert pc["producer_fallbacks"] == pc["producer_fallback_fused_group"] == PROJ_LAYERS, (r, pc)
        assert c["launches"]["codec_matmul_quantize"] == c["launches"]["codec_tf32_split"] == 0, (r, c)
    chk = prod["check"]
    assert chk["checked"] == PRODUCED_LAYERS and not chk["failed"] and chk["depths"] == [4], chk
    assert chk["b8"] == 0 and chk["counts"]["producer_dw_skipped"] == 0, chk
    exp, mono = sched["expected"], base["expected"]
    log(f"  sra_sched: launches a rank-step {({k: v for k, v in exp.items() if v})} against sra's "
        f"{({k: v for k, v in mono.items() if v})}; {slices} slices pipelined in 4 blocks; parameters and "
        f"losses after {sched['steps']} steps equal sra's on every rank")
    cp = sched["copies"]
    assert cp["copies"] * sched["steps"] == sched["sched"]["block_copies"], (cp, sched["sched"])
    assert cp["joins"] * sched["steps"] == sched["sched"]["join_copies"], (cp, sched["sched"])
    log(f"    block copies a rank-step: {cp['copies']}, summed per-call medians {cp['ms']:.3f} ms (host launch "
        f"included), bursts {cp['burst_ms']:.3f} ms ({cp['bytes'] / 2**20:.1f} MiB read and written, "
        f"{cp['bytes'] / cp['burst_ms'] / 1e6:.0f} GB/s in bursts) [{smi}]")
    log(f"    joins of the decoded blocks a rank-step: {cp['joins']}, summed per-call medians {cp['join_ms']:.3f} ms "
        f"(host launch included), bursts {cp['join_burst_ms']:.3f} ms ({cp['join_bytes'] / 2**20:.1f} MiB read "
        f"and written, {cp['join_bytes'] / cp['join_burst_ms'] / 1e6:.0f} GB/s in bursts); glue copies in all "
        f"{cp['burst_ms'] + cp['join_burst_ms']:.3f} ms in bursts [{smi}]")
    for name in ("sra", "sra_sched"):
        p = res[0][name].get("profile", {})
        log(f"    {name}, rank 0's profiled step: codec kernels {p.get('codec_ms', 0.0):.3f} ms "
            f"({', '.join(f'{k} {v:.3f}' for k, v in sorted(p.get('codec_by_kernel', {}).items()))}), "
            f"device busy {p.get('busy_ms', 0.0):.2f} ms of {p.get('wall_ms', 0.0):.1f} ms; host-clock "
            f"step {res[0][name]['step_s']:.3f} s (each {[round(t, 3) for t in res[0][name]['step_times']]}) "
            f"[{smi}]; largest device entries: " + "; ".join(f"{k[:50]} {v:.3f}" for k, v in p.get("top", [])[:6]))
    log(f"  sra_sched_ef: the round trip adds {rt_b2} B2 launches a rank-step (one a block; {4 * slices} blocks); host-clock "
        f"step {ef['step_s']:.3f} s; 64 MB slice card vs plain CPU bit-identical on every rank")
    log(f"  sra_producer_sched: {chk['checked']} layers staged per-block payloads (4 blocks, B1 from the "
        f"kept dw, no B8), each bit-identical to the quantize of its block of p.grad / {MR_WS}; consumed "
        f"{[o['sra_producer_sched']['producer']['producer_consumed_slices'] for o in res]} by rank; host-clock "
        f"step {prod['step_s']:.3f} s")


def planner_checks(res, smi: str) -> None:
    """Phase 7's checks of the step planner (CGX_PLANNER=on), each failing
    the phase: ``sra_planned``'s parameters and losses after its MR_STEPS
    steps from the seed equal ``sra``'s on every rank, every rank ran the
    same plan, and each slice of depth two or more pipelined in its planned
    blocks; ``sra_planned_bits``' checked slices (one of each width) equal
    the plain versions on the CPU, with the launches the model derives;
    ``sra_planned_producer`` consumed every produced layer's payload;
    ``sra_planned_producer_bits`` fell back (``plan``) for exactly the
    layers the plan moved and consumed the rest. Logs the plans, the
    launches and rank 0's profile beside ``sra_sched``'s and ``sra``'s."""
    base, sched, pl = res[0]["sra"], res[0]["sra_sched"], res[0]["sra_planned"]
    plan = pl["plan"]
    deep = [x for x in plan["slices"] if x[4] >= 2]
    blocks = sum(x[4] for x in deep)
    for r, o in enumerate(res):
        c = o["sra_planned"]
        diff = [k for k in c["step_digests"] if c["step_digests"][k] != o["sra"]["step_digests"][k]]
        assert not diff, ("sra_planned against sra", r, diff[:5])
        assert c["losses"] == o["sra"]["losses"], (r, c["losses"], o["sra"]["losses"])
        assert c["plan"] == plan, (r, "another plan")
        assert c["sched"]["pipelined_slices"] == len(deep) * c["steps"], (r, c["sched"], len(deep))
        assert c["sched"]["blocks"] == blocks * c["steps"], (r, c["sched"], blocks)
        assert c["sched"]["block_copies"] == c["sched"]["blocks"], (r, c["sched"])
        assert c["sched"]["join_copies"] == c["sched"]["pipelined_slices"], (r, c["sched"])
        assert c["planner"]["compiled"] + c["planner"]["cache_hits"] >= c["steps"], (r, c["planner"])
    depths = {}
    for _, _, n, bits, chunks in plan["slices"]:
        depths.setdefault((n, bits, chunks), 0)
        depths[(n, bits, chunks)] += 1
    log(f"  sra_planned (default model): {len(plan['slices'])} compressed slices, {sum(x[4] for x in plan['slices'])} "
        f"blocks a rank-step; (length, bits, depth) x slices: "
        + ", ".join(f"({n}, {b}, {c}) x {k}" for (n, b, c), k in sorted(depths.items()))
        + f"; predicted step {1e3 * plan['predicted_s']:.3f} ms ("
        + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in sorted(plan["components"].items())) + " ms)")
    exp = pl["expected"]
    log(f"    launches a rank-step {({k: v for k, v in exp.items() if v})} against sra_sched's "
        f"{({k: v for k, v in sched['expected'].items() if v})} and sra's "
        f"{({k: v for k, v in base['expected'].items() if v})}; parameters and losses after {pl['steps']} steps equal "
        f"sra's on every rank; block copies {pl['sched']['block_copies'] // pl['steps']} and joins "
        f"{pl['sched']['join_copies'] // pl['steps']} a rank-step")
    for name in ("sra", "sra_sched", "sra_planned"):
        p = res[0][name].get("profile", {})
        log(f"    {name}, rank 0's profiled step: codec kernels {p.get('codec_ms', 0.0):.3f} ms "
            f"({', '.join(f'{k} {v:.3f}' for k, v in sorted(p.get('codec_by_kernel', {}).items()))}), "
            f"device busy {p.get('busy_ms', 0.0):.2f} ms of {p.get('wall_ms', 0.0):.1f} ms; host-clock "
            f"step {res[0][name]['step_s']:.3f} s (each {[round(t, 3) for t in res[0][name]['step_times']]}) "
            f"[{smi}]")
    bits = res[0]["sra_planned_bits"]
    bp = bits["plan"]
    m = bp["model"]
    log(f"  sra_planned_bits (CGX_PLANNER_AVG_BITS={PLANNED_AVG_BITS}, the file's model, source "
        f"{m['source']!r}: quantize {m['quantize_gbps']:.3f} GB/s, dequantize {m['dequantize_gbps']:.3f} GB/s, "
        f"wire {m['wire_gbps']} GB/s, {1e6 * m['chunk_overhead_s']:.1f} us a block): (group, slice, length, "
        f"bits, depth) {bp['slices']}; predicted step {1e3 * bp['predicted_s']:.3f} ms; host-clock step "
        f"{bits['step_s']:.3f} s [{smi}]")
    comp = [(n, b) for _, _, n, b, _ in bp["slices"]]
    assert sum(n * b for n, b in comp) <= float(PLANNED_AVG_BITS) * sum(n for n, _ in comp), comp
    widths = sorted({b for _, b in comp})
    assert len(widths) > 1, widths
    for r, o in enumerate(res):
        c = o["sra_planned_bits"]
        assert c["plan"] == bp, (r, "another plan")
        assert [w["bits"] for w in c["widths"]] == widths, (r, c["widths"])
        for w in c["widths"]:
            assert w["same"] and w["launches"] == w["expected"], (r, w)
    for w in bits["widths"]:
        log(f"    {w['bits']}-bit slice of group {w['group']} ({w['n']} values, depth {w['chunks']}): card vs plain "
            f"CPU bit-identical on every rank; rank 0's launches {({k: v for k, v in w['launches'].items() if v})} "
            f"as the launch model's")
    for name in ("sra_planned_producer", "sra_planned_producer_bits"):
        for r, o in enumerate(res):
            c = o[name]
            pc, mv = c["producer"], c["moved"]
            moved = len(mv["bits"]) + len(mv["depth"])
            assert mv["staged"] == PRODUCED_LAYERS, (name, r, mv)
            assert pc["producer_staged"] == PRODUCED_LAYERS, (name, r, pc)
            assert pc["producer_fallback_plan"] == moved, (name, r, pc, mv)
            assert pc["producer_consumed_slices"] == PRODUCED_LAYERS - moved, (name, r, pc, mv)
            assert pc["producer_fallbacks"] == PROJ_LAYERS + moved, (name, r, pc)
            assert pc["producer_fallback_fused_group"] == PROJ_LAYERS, (name, r, pc)
            assert pc["producer_dw_skipped"] == 0, (name, r, pc)
            assert (moved == 0) == (name == "sra_planned_producer"), (name, r, mv)
        c = res[0][name]
        log(f"  {name}: {c['producer']['producer_staged']} payloads staged a rank-step, "
            f"{c['producer']['producer_consumed_slices']} consumed, "
            f"{c['producer']['producer_fallback_plan']} fell back as 'plan' (the plan moved the width of "
            f"{len(c['moved']['bits'])} and the depth of {len(c['moved']['depth'])}), "
            f"{c['producer']['producer_kernel_slices']} from the matmul-quantize (B8 launches "
            f"{c['launches']['codec_matmul_quantize']}); launches {({k: v for k, v in c['launches'].items() if v})} "
            f"as the launch model's; host-clock step {c['step_s']:.3f} s [{smi}]")


def ef_guard_check(res) -> None:
    """Phase 7's checks of the error-feedback and guard configurations, each
    failing the phase: the EF launches equal the plain configuration's plus
    the round trip's (``LaunchModel.roundtrip``: the flat SRA one B2 a
    slice, the two-level leader scheme one B1 and one B2), the round trip
    of a 64 MB slice equal to the plain CPU path's, its residual within half
    a unit of its bucket of the wire layout and 0 on the own row; the
    residuals after the steps nonzero, finite, float32; under "skip" the
    poisoned step kept the parameters and Adam, under "exact" it changed
    them, finite; the clean step equal to the unguarded one; the counter 1
    on rank 0."""
    for name, base, extra in (("sra_ef", "sra", {"codec_dequantize": 1}),
                              ("two_level_ef", "two_level", {"codec_quantize": 1, "codec_dequantize": 1})):
        c0 = res[0][name]
        slices = c0["slices"]
        want = {k: v + extra.get(k, 0) * slices for k, v in res[0][base]["expected"].items()}
        p = c0.get("profile", {})
        log(f"  {name}: the round trip adds {({k: v - res[0][base]['expected'][k] for k, v in c0['expected'].items() if v != res[0][base]['expected'][k]})} "
            f"launches a rank-step over {base}'s ({slices} fusion slices); host-clock step "
            f"{c0['step_s']:.3f} s against {base}'s {res[0][base]['step_s']:.3f} s; rank 0's profiled step: "
            f"codec kernels {p.get('codec_ms', 0.0):.3f} ms ({', '.join(f'{k} {v:.3f}' for k, v in sorted(p.get('codec_by_kernel', {}).items()))}), "
            f"device busy {p.get('busy_ms', 0.0):.2f} ms of {p.get('wall_ms', 0.0):.1f} ms; {base}'s codec "
            f"{res[0][base].get('profile', {}).get('codec_ms', 0.0):.3f} ms, busy "
            f"{res[0][base].get('profile', {}).get('busy_ms', 0.0):.2f} ms")
        for label in (base, name):
            top = res[0][label].get("profile", {}).get("top", [])
            log(f"    {label} profile's largest device entries: " + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
        rb = c0["residual"]
        log(f"    64 MB slice round trip: residual nonzero in {rb['nonzero']} values, within half a unit "
            f"of its bucket everywhere: {rb['within']} (largest share of the bound {rb['max_ratio']:.4f}), "
            f"own row 0: {rb['own_zero']}; residuals after the steps: {c0['ef']}")
        assert c0["expected"] == want and slices > 0, (name, c0["expected"], want)
        for r, o in enumerate(res):
            c = o[name]
            rb, ef = c["residual"], c["ef"]
            assert rb["within"] and rb["own_zero"] and rb["nonzero"] > 0, (name, r, rb)
            assert ef["nonzero"] > 0 and ef["finite"] and ef["f32"] and ef["n"] == len(c["digests"]), (name, r, ef)
            assert c["slice_same"], (name, r)
    for name in ("sra_guard_skip", "sra_guard_exact"):
        c0 = res[0][name]
        log(f"  {name}: rank {GUARD_RANK}'s loss NaN at step {GUARD_STEP}: losses {c0['losses']}, steps "
            f"{[round(t, 3) for t in c0['step_times']]} s; the clean step equals the unguarded one: "
            f"{c0['clean_equals_off']}; the poisoned step kept the parameters {c0['kept_params']}, Adam "
            f"{c0['kept_adam']}, finite {c0['finite']}; counter {[o[name]['count'] for o in res]}")
        for r, o in enumerate(res):
            c = o[name]
            assert c["count"] == (1 if r == 0 else 0), (name, r, c["count"])
            assert c["clean_equals_off"] and c["finite"], (name, r, c)
            assert np.isnan(c["losses"][GUARD_STEP]), (name, r, c["losses"])
            if name.endswith("skip"):
                assert c["kept_params"] and c["kept_adam"], (name, r)
            else:
                assert not c["kept_params"], (name, r)


def hook_check(res, name: str, smi: str) -> None:
    """Phase 7's checks of the DDP configuration ``name``, each failing the
    run: the registry against ``should_compress_``, the bucket allreduces
    on the worker thread, replicas after every step, the captured buckets'
    kernel-vs-plain reruns, the launches against ``LaunchModel.hook`` on
    every rank (leaders and non-leaders under the two-level scheme), and
    whether the two-level scheme ran. Times are gloo's, through host
    memory."""
    h0 = res[0][name]
    hier = name.startswith("ddp_hook_hier")
    comp = sum(1 for _, b in h0["registered"] if b == BITS)
    log(f"  {name}: DistributedDataParallel + cgx_hook, float32 GPT-2 124M, {HOOK_STEPS} steps "
        f"over hosts {h0['hosts'] if hier else 'one host'}; {len(h0['registered'])} layers "
        f"registered ({comp} compressed, {len(h0['registered']) - comp} raw) in {h0['calls']} "
        f"buckets a step, reduced on {h0['threads']}")
    log(f"    losses on rank 0 {h0['losses']}")
    for r, o in enumerate(res):
        log(f"    hook launches on rank {r} over steps 2-{HOOK_STEPS - 1}: {o[name]['launches']} "
            f"(LaunchModel.hook: {o[name]['expected']})")
    log(f"    host-clock step after registration {h0['hook_s']:.3f} s, of which the replica "
        f"digest {h0['digest_s']:.3f} s; the configuration {h0['seconds']:.1f} s on rank 0 (gloo, "
        f"wire through host memory) [{smi}]")
    for r, o in enumerate(res):
        h = o[name]
        assert h["hier"] == hier, (name, r, h["hier"], h["hosts"])
        assert h["threads"] and all(t.startswith("cgx-bucket-worker") for t in h["threads"]), (
            name, r, h["threads"])
        assert h["registered"] == h["want"], (r, h["registered"][:5], h["want"][:5])
        assert len(h["registered"]) == len(h0["digests"][0]), (r, len(h["registered"]))
        assert np.all(np.isfinite(h["losses"])), (r, h["losses"])
        assert h["launches"] == h["expected"], (name, r, h["launches"], h["expected"])
        for step, d in enumerate(h["digests"]):
            diff = [k for k in d if d[k] != h0["digests"][step][k]]
            assert not diff, (name, "replicas", r, step, diff[:5])
        for ri, (label, rr) in enumerate(h["reruns"].items()):
            want_buckets = len(_rerun_buckets(list(range(h0["calls"])), name, ri))
            assert rr["buckets"] == want_buckets, (name, r, label, rr)
            assert rr["same"] == rr["buckets"], (name, r, label, rr)
            assert rr["launches"] == rr["expected"], (name, r, label, rr["launches"], rr["expected"])
            assert rr["int8"] == 0, (name, r, label, rr["int8"])
            if label == HOOK_INT8_RERUN:  # its buckets' bytes are the exact fold's
                first = next(iter(h["reruns"].values()))
                assert rr["digests"] == _rerun_buckets(first["digests"], name, ri), (name, r, label)
            # The pipelined SRA ran (on a leader only, under the two-level
            # scheme: the leaders' cross stage) and its buckets' bytes are
            # the monolithic SRA's.
            assert bool(rr["pipelined"]) == (label in HOOK_SCHED_OF and (not hier or r % MR_INTRA == 0)), (
                name, r, label, rr["pipelined"])
            # Where it ran, every bucket pipelined, in the card's reduce and
            # the plain one, each at the default depth (under the planner:
            # at planner.bridge_chunks', the buckets all deep enough for two).
            if label == HOOK_PLANNED_RERUN:
                assert len(rr["bridge"]) == 2 * rr["buckets"] and min(rr["bridge"]) >= 2, (name, r, rr["bridge"])
                assert rr["pipelined"] == rr["bridge"], (name, r, label, rr["pipelined"], rr["bridge"])
            else:
                assert not rr["pipelined"] or rr["pipelined"] == [HOOK_SCHED_DEPTH] * (2 * rr["buckets"]), (
                    name, r, label, rr["pipelined"])
            if label in HOOK_SCHED_OF:
                mono_ri = list(h["reruns"]).index(HOOK_SCHED_OF[label])
                mono = h["reruns"][HOOK_SCHED_OF[label]]["digests"]
                want = _rerun_buckets(mono, name, ri) if _all_buckets(name, mono_ri) else mono
                assert rr["digests"] == want, (name, r, label)
    # The path's kernels each ran in the counted steps: the quantizes and
    # requantizes (B1), the decodes (B2), and in the flat SRA the fused
    # epilogue (B3) on the segments of whole chunks. Under the two-level
    # scheme a leader's counts differ from a non-leader's.
    for k in ("codec_quantize", "codec_dequantize") + (() if hier else ("codec_sra_epilogue",)):
        assert h0["launches"][k] > 0, (name, k, h0["launches"])
    if hier:
        assert res[0][name]["expected"] != res[1][name]["expected"], (res[0][name]["expected"],)
        # Inside the leaders' cross stage: B3 under cross SRA, B4 under
        # cross all-to-all, on each leader (ranks 0 and 2).
        for r in range(0, MR_WS, MR_INTRA):
            rr = res[r][name]["reruns"]
            if "cross SRA float32" in rr:
                assert rr["cross SRA float32"]["launches"]["codec_sra_epilogue"] > 0, (r, rr)
                assert rr["cross ALLTOALL float32"]["launches"]["codec_reduce_rows"] > 0, (r, rr)
        # Every leader sent the same stage-3 frames (under stochastic
        # rounding: drawn from the generator the leaders seed alike).
        frames = [res[r][name]["stage3"] for r in range(0, MR_WS, MR_INTRA)]
        assert frames[0] and all(f == frames[0] for f in frames), (name, [len(f) for f in frames])
        assert not any(res[r][name]["stage3"] for r in range(MR_WS) if r % MR_INTRA), name
        log(f"    the leaders' {len(frames[0])} stage-3 frames over steps 0-{HOOK_STEPS - 1} identical")
    log(f"    replicas: all {len(h0['digests'][0])} parameters bit-identical on the {MR_WS} ranks "
        f"after each of the {HOOK_STEPS} steps")
    for label, rr in h0["reruns"].items():
        if label in HOOK_SCHED_OF:
            mono = h0["reruns"][HOOK_SCHED_OF[label]]
            same = _rerun_buckets(mono["card_s"], name, list(h0["reruns"]).index(label)) if (
                len(mono["card_s"]) > len(rr["card_s"])) else mono["card_s"]
            knob = "CGX_PLANNER=on" if label == HOOK_PLANNED_RERUN else "CGX_SCHEDULE=on"
            log(f"    under {label} ({knob}) the hook's buckets equal {HOOK_SCHED_OF[label]}'s on every "
                f"rank; pipelined SRAs on rank 0 {len(rr['pipelined'])} (sub-chunks {sorted(set(rr['pipelined']))}); "
                f"the card's reduce of its {rr['buckets']} buckets on rank 0 {1e3 * sum(rr['card_s']):.1f} ms "
                f"(each {[round(1e3 * t, 1) for t in rr['card_s']]}) against {HOOK_SCHED_OF[label]}'s "
                f"{1e3 * sum(same):.1f} ms on the same buckets (each {[round(1e3 * t, 1) for t in same]}; host "
                f"clock, gloo) [{smi}]")
        if label == HOOK_INT8_RERUN:
            log(f"    under {label} the hook's buckets equal its exact ones on every rank (no int8 "
                f"instance ran: the hook folds exactly)")
        log(f"    step {HOOK_CAPTURE_STEP}'s {rr['buckets']} of {h0['calls']} buckets ({rr['values']} values) "
            f"reduced again under {label}, kernels vs plain CPU: bit-identical on every rank "
            f"({rr['seconds']:.1f} s on rank 0) [{smi}]; launches on each rank as LaunchModel.hook, "
            f"rank 0's {({k: v for k, v in rr['launches'].items() if v})}")


# ---------------------------------------------------------------------------


def ptxas_report(ptxas: str) -> None:
    """Registers, spills and shared memory of the build: the f32
    instances against ``csrc/ptxas_f32.json`` (the source before the 16-bit
    instances existed, ``tools/ptxas_table.py``), the differences logged
    (``test_f32_instances_keep_their_registers`` holds them); the pipelined
    kernels' shared memory at the slice's shapes; the cluster kernels' (B1,
    B3, B7a, B7c) within and past the register budget, round to nearest and
    stochastic, f32 and 16-bit; B4's by width, raw row and row count."""
    from pathlib import Path

    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.tools import ptxas_table

    table = codec_cuda.ptxas_instances(ptxas)
    f32 = ptxas_table.f32_table(table)
    spilled = {k: v for k, v in f32.items() if v["spill_stores"] or v["spill_loads"]}
    log(f"  ptxas: {len(table)} kernels ({len(table) - len(f32)} 16-bit or split TF32), at most "
        f"{max(v['registers'] for v in table.values())} registers a thread; {len(spilled)} f32 "
        f"instances with spills")
    for k, v in spilled.items():
        log(f"    {k}: {v['spill_stores']} bytes spill stores, {v['spill_loads']} bytes spill loads")
    baseline = json.loads((Path(codec_cuda.SOURCE).parent / "ptxas_f32.json").read_text())
    diff = ptxas_table.compare(table, baseline)
    log(f"  f32 instances against csrc/ptxas_f32.json: {len(baseline) - len(diff)}/{len(baseline)} "
        f"with equal registers, spills and static shared memory"
        + (f"; first differences {diff[:5]}" if diff else ""))

    def of(kernel, wire16=False):
        return {k: v for k, v in table.items()
                if k.startswith(kernel + "<") and k.endswith(":16") == wire16}

    def args(k):
        return [int(a) for a in k.split("<")[1].split(">")[0].split(",")]

    chunks = FLAT_N // (32 * BUCKET)
    mine = of("cgx_dequantize_db_kernel")
    r = [v["registers"] for v in mine.values()]
    tc = codec_cuda._pipe_tc(chunks, codec_cuda.db_tc_cap("dequantize", BITS, BUCKET))
    log(f"  cgx_dequantize_db_kernel: {len(mine)} instances, {min(r)}-{max(r)} registers a thread, "
        f"{codec_cuda.db_smem_bytes('dequantize', tc, BITS, BUCKET)} bytes dynamic shared memory "
        f"at {BITS} bits, bucket {BUCKET}, tc {tc}; 512 threads a block")
    assert len(mine) == 16, len(mine)
    # B7a and B7c: their ring (and the butterfly stage) at the slice's
    # shape, beside the static shared memory the Python geometry assumes.
    for kernel, short in (("cgx_quantize_db_cluster_kernel", "quantize"),
                          ("cgx_sra_epilogue_db_cluster_kernel", "epilogue")):
        for wire16, elem in ((False, 4), (True, 2)):
            mine = of(kernel, wire16)
            static = max(v["smem"] for v in mine.values())
            ring = codec_cuda.db_ring(short, chunks, BITS, BUCKET, elem_size=elem)
            dyn = {p: codec_cuda.db_smem_bytes(short, 1, BITS, BUCKET, chunks=chunks, pack=p,
                                               elem_size=elem) for p in codec_cuda.PACKS}
            log(f"  {kernel} ({'16-bit' if wire16 else 'f32'}): {len(mine)} instances, {static} "
                f"bytes static shared memory (the geometry assumes "
                f"{codec_cuda.DB_CLUSTER_STATIC_BYTES}); at {chunks} chunks of {BUCKET} at {BITS} bits "
                f"{ring.slots} slot(s) of {ring.slot_bytes} bytes, {dyn['sum']} bytes dynamic "
                f"({dyn['butterfly']} butterfly), {ring.geometry}")
            # 64 round-to-nearest instances and 64 stochastic ones.
            assert len(mine) == 128 and static <= codec_cuda.DB_CLUSTER_STATIC_BYTES, (kernel, len(mine))
    # The quantizing kernels by (encode, pack) lowering: registers and
    # static shared memory over their bit widths.
    for kernel in ("cgx_quantize_cluster_kernel", "cgx_sra_epilogue_cluster_kernel",
                   "cgx_matmul_quantize_kernel",
                   "cgx_quantize_db_cluster_kernel", "cgx_sra_epilogue_db_cluster_kernel"):
        by = {}
        for k, v in of(kernel).items():
            a = args(k)
            by.setdefault(("div", "mul")[a[1]] + "/" + ("sum", "butterfly")[a[2]], []).append(
                (v["registers"], v["smem"]))
        log(f"  {kernel}: " + "; ".join(
            f"{k} {min(v)[0]}-{max(v)[0]} registers, {max(s for _, s in v)} bytes static"
            for k, v in sorted(by.items())))
        assert len(by) == 4, (kernel, sorted(by))
    mm16, mm32 = of("cgx_matmul_quantize_kernel", True), of("cgx_matmul_quantize_kernel")
    delta = [v["registers"] - mm32[k[:-3]]["registers"] for k, v in mm16.items()]
    log(f"  cgx_matmul_quantize_kernel (16-bit operands): {len(mm16)} instances, "
        f"{min(v['registers'] for v in mm16.values())}-{max(v['registers'] for v in mm16.values())} "
        f"registers a thread ({min(delta):+d} to {max(delta):+d} against the f32 twins), "
        f"{sum(1 for v in mm16.values() if v['spill_stores'] or v['spill_loads'])} with spills, "
        f"{max(v['smem'] for v in mm16.values())} bytes static shared memory")
    assert len(mm16) == 32, len(mm16)  # bits 1-8 x the four lowerings
    # B8's tensor-core kernel: bits 1-8 x the four lowerings x bf16, f16.
    tc = of("cgx_matmul_quantize_tc_kernel", True)
    for fmt, fname in ((1, "bf16"), (2, "f16")):
        mine = [v for k, v in tc.items() if args(k)[3] == fmt]
        r = [v["registers"] for v in mine]
        spill = [v for v in mine if v["spill_stores"] or v["spill_loads"]]
        log(f"  cgx_matmul_quantize_tc_kernel ({fname}): {len(mine)} instances, {min(r)}-{max(r)} "
            f"registers a thread (288 threads, one block an SM), {len(spill)} with spills (at most "
            f"{max([v['spill_stores'] for v in spill] or [0])} bytes stored), "
            f"{max(v['smem'] for v in mine)} bytes static shared memory")
        assert len(mine) == 32, (fname, len(mine))
    # B8's float32 operands on the tensor cores: the split-TF32 kernel (bits
    # 1-8 x the four lowerings) and the split pass.
    mine = list(of("cgx_matmul_quantize_tf32_kernel").values())
    r = [v["registers"] for v in mine]
    spill = [v for v in mine if v["spill_stores"] or v["spill_loads"]]
    split = table["cgx_tf32_split_kernel"]
    log(f"  cgx_matmul_quantize_tf32_kernel: {len(mine)} instances, {min(r)}-{max(r)} registers a thread "
        f"(288 threads, one block an SM), {len(spill)} with spills (at most "
        f"{max([v['spill_stores'] for v in spill] or [0])} bytes stored, "
        f"{max([v['spill_loads'] for v in spill] or [0])} loaded), {max(v['smem'] for v in mine)} bytes "
        f"static shared memory; cgx_tf32_split_kernel {split['registers']} registers, {split['smem']} "
        f"bytes static shared memory")
    assert len(mine) == 32, len(mine)
    for kernel in ("cgx_quantize_cluster_kernel", "cgx_sra_epilogue_cluster_kernel",
                   "cgx_quantize_db_cluster_kernel", "cgx_sra_epilogue_db_cluster_kernel"):
        for wire16 in (False, True):
            for reread, what in ((0, "one position (32 values) a thread"),
                                 (1, "REREAD, positions in rounds")):
                for stoch, how in ((0, "round to nearest"), (1, "stochastic")):
                    mine = [v for k, v in of(kernel, wire16).items() if args(k)[3:5] == [reread, stoch]]
                    r = [v["registers"] for v in mine]
                    spill = [v for v in mine if v["spill_stores"] or v["spill_loads"]]
                    most = max([v["spill_stores"] for v in spill] or [0])
                    log(f"  {kernel} ({'16-bit' if wire16 else 'f32'}, {what}, {how}): {len(mine)} "
                        f"instances, {min(r)}-{max(r)} registers a thread, {len(spill)} with spills "
                        f"(at most {most} bytes stored); at most 512 threads a CTA")
                    assert len(mine) == 32, (kernel, wire16, reread, stoch, len(mine))
    # B4: registers and spills by width, raw row (f32 or 16-bit) and row
    # count (0: any).
    by = {}
    for wire16 in (False, True):
        for k, v in of("cgx_reduce_rows_kernel", wire16).items():
            _, rows, vec, raw = args(k)
            by.setdefault((vec, "16-bit" if wire16 else ("f32" if raw else "no"), rows), []).append(
                (v["registers"], bool(v["spill_stores"] or v["spill_loads"])))
    for vec in (4, 1):
        for raw in ("f32", "16-bit", "no"):
            log(f"  cgx_reduce_rows_kernel vec={vec} raw row {raw}, registers over bits 1-8, by row "
                f"count: " + "; ".join(
                    f"{rows or 'any'}: {min(v)[0]}-{max(v)[0]}"
                    + (f" ({sum(sp for _, sp in v)} spill)" if any(sp for _, sp in v) else "")
                    for (vv, rr, rows), v in sorted(by.items(), key=lambda kv: (kv[0][2] or 99))
                    if (vv, rr) == (vec, raw)))
    # Full width: bits 1-8 x rows 1-8 and any x raw row (f32, 16-bit) or
    # not; scalar width: the any-count instance alone.
    assert sum(len(v) for k, v in by.items() if k[0] == 4) == 216, by
    assert sorted(k for k in by if k[0] == 1) == [(1, "16-bit", 0), (1, "f32", 0), (1, "no", 0)], sorted(by)
    assert all(len(by[k]) == 8 for k in by if k[0] == 1), by
    # B9 on B1's cluster body: bits 1-8 x 3 variants x REREAD, beside B1's
    # div/sum round-to-nearest f32 twins.
    mine = of("cgx_quantize_variant_cluster_kernel")
    b1 = of("cgx_quantize_cluster_kernel")
    by = {}
    for k, v in mine.items():
        bits, variant, reread = args(k)
        twin = b1[f"cgx_quantize_cluster_kernel<{bits},0,0,{reread},0>"]
        by.setdefault((("nometa", "metalane", "read")[variant], reread), []).append(
            (v["registers"], v["registers"] - twin["registers"], v["spill_stores"], v["smem"]))
    log("  cgx_quantize_variant_cluster_kernel, by variant (and REREAD): registers over bits 1-8 "
        "(against B1's twin), spill stores, static shared memory: " + "; ".join(
            f"{var}{' reread' if rr else ''} {min(v)[0]}-{max(v)[0]} ({min(d for _, d, _, _ in v):+d}.."
            f"{max(d for _, d, _, _ in v):+d}), {max(sp for _, _, sp, _ in v)} B, "
            f"{max(sm for _, _, _, sm in v)} B" for (var, rr), v in sorted(by.items())))
    assert len(mine) == 48 and not of("cgx_quantize_variant_kernel"), sorted(mine)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    from torch_cgx_tpu_torch.models import GPT2Config
    from torch_cgx_tpu_torch.ops import codec_cuda
    from torch_cgx_tpu_torch.utils.device import card_line

    t_start = time.perf_counter()
    # An empty autotune cache of the run's own: nothing is read or written
    # under the home directory, and CGX_PALLAS_DB is "off" but where a phase
    # sets it.
    cache = tempfile.TemporaryDirectory()
    os.environ.update({
        "CGX_COMPRESSION_QUANTIZATION_BITS": str(BITS),
        "CGX_COMPRESSION_BUCKET_SIZE": str(BUCKET),
        "CGX_DEBUG_FORCE_CODEC": "1",
        "CGX_PALLAS_DB": "off",
        "CGX_AUTOTUNE_DIR": cache.name,
    })
    for k in ("CGX_SRA_EPILOGUE", "CGX_FUSION_BUFFER_SIZE_MB", "CGX_STANDALONE_LAYER_ELEMS",
              "CGX_AUTOTUNE", "CGX_PALLAS_TILE_CHUNKS", "CGX_PALLAS_PACK", "CGX_CODEC_ENCODE"):
        os.environ.pop(k, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase("1. device")
    smi = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {name}; "
        f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")

    phase("2. build")
    t0 = time.perf_counter()
    lib = codec_cuda.build(force=True)
    log(f"  nvcc built {lib.name} in {time.perf_counter() - t0:.1f} s")
    parts = codec_cuda.BUILD_LOG["part_seconds"]
    slow = max(range(len(parts)), key=parts.__getitem__)
    log(f"  part 1 (B2/B6, B7b, B9) compiled in {parts[1]:.1f} s, the slowest (part {slow}) in "
        f"{parts[slow]:.1f} s, all at once; by part: "
        + " ".join(f"{k}:{t:.1f}" for k, t in enumerate(parts)))
    int8_build = start_int8_build()
    ptxas_report(str(codec_cuda.BUILD_LOG.get("ptxas", "")))
    philox_result = start_philox_sass(lib)

    phase("3. kernels against their plain versions (pipelined ones also against the single-stage)")
    max_err = check_kernels(dev, FLAT_N, TAIL_N, SRA_WS)
    torch.cuda.synchronize()

    phase("4. GPT-2 124M slice (CGX_PALLAS_DB=off, then the pipelined path, then the lowerings, "
        "then stochastic rounding)")
    cfg = GPT2Config.small()
    sl = gpt2_slice(dev, cfg, BATCH, SEQ, STEPS)
    db = db_phase(dev, cfg, sl, STEPS)
    lowering_phase(dev, cfg, sl, STEPS)
    sr = stochastic_phase(dev, cfg, sl)
    del os.environ["CGX_STOCHASTIC_ROUNDING"]
    torch.cuda.empty_cache()
    bf = bf16_phase(dev, cfg, sl["tokens"], STEPS)
    torch.cuda.empty_cache()

    phase("5. times")
    t5 = time.perf_counter()
    philox = philox_result()
    log(f"  waited {time.perf_counter() - t5:.1f} s for the SASS count")
    kern, copy_gbps = time_kernels(dev, FLAT_N, name)
    kern += time_mm32(dev, name)
    sr_times = time_stochastic(dev, FLAT_N, name, philox)
    time_step_shapes(dev, name)
    plain_ms, codec_ms, db_ms, plain_step = time_steps(sl)
    log(f"  train step, GPT-2 124M {BATCH}x{SEQ}: {plain_ms:.2f} ms without the codec, "
        f"{codec_ms:.2f} ms with it (+{100 * (codec_ms - plain_ms) / plain_ms:.1f}%), "
        f"{db_ms:.2f} ms with it under CGX_PALLAS_DB=on (+{100 * (db_ms - plain_ms) / plain_ms:.1f}%); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_step("step without the codec", plain_step)
    profile_step("step with the codec", lambda: sl["step"](sl["tokens"]))
    os.environ["CGX_PALLAS_DB"] = "on"
    profile_step("step with the codec, CGX_PALLAS_DB=on", lambda: sl["step"](sl["tokens"]))
    os.environ["CGX_PALLAS_DB"] = "off"
    os.environ["CGX_STOCHASTIC_ROUNDING"] = "1"
    from torch_cgx_tpu_torch.utils.device import mem_rate

    for k, b in stochastic_step_bounds(mem_rate(name), philox).items():
        log(f"  stochastic {k} a step: {b['launches']} launches, bound {b['bound_ms']:.4f} ms (bytes or "
            f"the Philox's busiest pipe, whichever is larger a launch; computed)")
    profile_step("step with the codec, CGX_STOCHASTIC_ROUNDING=1", lambda: sr["step"](sr["tokens"]))
    os.environ["CGX_PALLAS_DB"] = "on"
    profile_step("step with the codec, CGX_STOCHASTIC_ROUNDING=1, CGX_PALLAS_DB=on",
                 lambda: sr["step"](sr["tokens"]))
    os.environ["CGX_PALLAS_DB"] = "off"
    del os.environ["CGX_STOCHASTIC_ROUNDING"], sr
    wire16 = time_wire16(dev, name)
    mm16 = time_mm16(dev, name)
    b_plain, b_codec, b_db, b_plain_step = time_steps(bf)
    log(f"  train step, GPT-2 124M {BATCH}x{SEQ}, bf16 parameters: {b_plain:.2f} ms without the codec, "
        f"{b_codec:.2f} ms with it (+{100 * (b_codec - b_plain) / b_plain:.1f}%), {b_db:.2f} ms with it "
        f"under CGX_PALLAS_DB=on (+{100 * (b_db - b_plain) / b_plain:.1f}%); float32 parameters "
        f"{plain_ms:.2f} / {codec_ms:.2f} / {db_ms:.2f} ms (above)")
    for k, b in shapebench_step_bounds(name, "bfloat16").items():
        log(f"  bf16 parameters, {k} a step: {b['launches']} launches, bound {b['bound_ms']:.4f} ms "
            f"(step_bounds, {b['bytes']} bytes)")
    host_split({"float32 parameters": sl, "bf16 parameters": bf})
    profile_step("bf16-parameter step without the codec", b_plain_step)
    profile_step("bf16-parameter step with the codec", lambda: bf["step"](bf["tokens"]))
    os.environ["CGX_PALLAS_DB"] = "on"
    profile_step("bf16-parameter step with the codec, CGX_PALLAS_DB=on",
                 lambda: bf["step"](bf["tokens"]))
    os.environ["CGX_PALLAS_DB"] = "off"
    del bf, b_plain_step
    launches = dict(sl["launches"])
    for k in DB_KEYS:
        launches[k] = db["launches"][k]

    phase("5b. the int8 fold (CGX_SRA_ACCUM=int8): B3, B7c and B4 against their plain versions, "
          "the slice's steps, times")
    build_s, waited = int8_build()
    log(f"  nvcc built {codec_cuda.LIBRARY_INT8.name} in {build_s:.1f} s on a thread beside phases "
        f"3-5; waited {waited:.1f} s for it")
    ptxas_report_int8(str(codec_cuda.INT8_BUILD_LOG.get("ptxas", "")))
    int8_err = check_int8(dev)
    i8 = int8_phase(dev, cfg, sl, STEPS)
    del sl, plain_step
    int8_times = time_int8(dev, name)
    os.environ["CGX_SRA_ACCUM"] = "int8"
    profile_step("step with the codec, CGX_SRA_ACCUM=int8", lambda: i8["step"](i8["tokens"]))
    os.environ["CGX_PALLAS_DB"] = "on"
    profile_step("step with the codec, CGX_SRA_ACCUM=int8, CGX_PALLAS_DB=on",
                 lambda: i8["step"](i8["tokens"]))
    os.environ["CGX_PALLAS_DB"] = "off"
    del os.environ["CGX_SRA_ACCUM"], i8
    torch.cuda.empty_cache()

    phase(f"6. qbench: the quantize variants at 128 MB, 4 bits, bucket 512, k = 8 (sra_epilogue ws 8); "
          f"{', '.join(QBENCH_SPLIT)} also at {QBENCH_STEP_MB} MB; B1's split")
    qb = qbench_phase(dev, copy_gbps)
    launches["codec_quantize_variant"] = qb["launches"]
    torch.cuda.empty_cache()

    phase(f"7. multi-rank: {MR_WS} ranks on the card (cross {MR_WS // MR_INTRA} x intra "
          f"{MR_INTRA}), gloo, GPT-2 124M, {MR_BATCH}x{SEQ} tokens a rank")
    t7 = time.perf_counter()
    mr = multirank_phase(smi=smi, planner_model=db["planner_model"])
    log(f"  phase 7 took {time.perf_counter() - t7:.1f} s [{smi}]")
    launches["codec_reduce_rows"] = mr["launches"]["codec_reduce_rows"]
    for k in ("codec_matmul_quantize", "codec_tf32_split"):
        launches[k] = mr["launches"][k]
    for k, v in mr["int8_launches"].items():
        int8_times[k].update(int8_launches=v, int8_max_abs_err=int8_err[k])
    cache.cleanup()
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    # One record a kernel: its launches on the path that runs it (phase 4
    # for the three of the world-size-1 slice and, from its forced run, the
    # three pipelined ones; phase 6 for the variant kernel; phase 7's
    # two-level steps for the reduce, its producer-fused flat SRA step for
    # the matmul-quantize and its split pass) and its time at that path's
    # (first) shape.
    records = []
    for r in kern:
        if any(x["name"] == r["name"] for x in records):
            continue
        records.append({
            "name": r["name"], "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNELS[r["name"]], "launches": launches[r["name"]],
            "max_abs_err": max_err[r["name"]], "ms": r["ms"], "burst_ms": r["burst_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("shape", "tiles", "ffma_ms", "ffma_burst_ms", "ffma_bound_ms",
                                 "library_burst_ms", "unfused_ms", "split_burst_ms") if k in r},
            **sr_times.get(r["name"], {}), **wire16.get(r["name"], {}),
            **int8_times.get(r["name"], {}),
        })
    records.append({
        "name": MM16, "route": "cuda", "source": SOURCE, "replaces": MM16_REPLACES,
        "launches": mr["mm16_launches"], "max_abs_err": max_err[MM16],
        **{k: mm16[k] for k in ("ms", "burst_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                "shape", "tiles", "ffma_bound_ms", "ffma_burst_ms", "f32_burst_ms",
                                "library_burst_ms")},
    })
    assert len(records) == len(TPU_KERNELS) + 1, records
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
