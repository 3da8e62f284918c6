r"""The named variants of the scan kernels (``kernels/k3_variants.py`` for K3/K3s,
``kernels/k4_variants.py`` for K4), of the warp backward and forward
(``kernels/warp_bwd_variants.py``, ``kernels/warp_fwd_variants.py``) and of K9's
and K8's bf16 kernels (``kernels/k9_variants.py``, ``kernels/k8_variants.py``) still apply
to the sources as they stand.

Each variant is a set of text replacements in a kernel's source; an edit whose
text no longer occurs exactly once would build a variant that is not the one
its name says. These tests need no card: they only read the sources (and count, on the CPU,
where the warp's taps land under a given tiling, which tiling the forward takes on an H100,
and which plans K9's and K8's bf16 kernels take).
"""
import itertools
import math

import numpy as np
import pytest
import torch

from vp_suite_tpu_torch.kernels import (k3_variants, k4_variants, k8_variants, k9_variants,
                                        warp_bwd_variants, warp_fwd_variants)
from vp_suite_tpu_torch.ops.warp import _bf16_contract_operands

CASES = [pytest.param(k3_variants, "convlstm_scan.cu", name, id=f"K3-{name}") for name in k3_variants.EDITS] \
    + [pytest.param(k4_variants, "convlstm_scan_bwd.cu", name, id=f"K4-{name}") for name in k4_variants.EDITS] \
    + [pytest.param(warp_bwd_variants, "warp_sample.cu", name, id=f"warp_bwd-{name}")
       for name in warp_bwd_variants.EDITS] \
    + [pytest.param(warp_fwd_variants, "warp_sample.cu", name, id=f"warp_fwd-{name}")
       for name in warp_fwd_variants.EDITS] \
    + [pytest.param(k9_variants, "warp_contract.cu", name, id=f"K9-{name}") for name in k9_variants.EDITS] \
    + [pytest.param(k8_variants, "warp_ret.cu", name, id=f"K8-{name}") for name in k8_variants.EDITS]


@pytest.mark.parametrize("tool,source,name", CASES)
def test_variant_edit_anchor_occurs_once(tool, source, name):
    kernel = tool.variant_source("kernel")
    assert kernel == tool.apply_edits(source, {}, name)   # "kernel" is the source as it stands
    for old, new in tool.EDITS[name]:
        assert old != new
        assert kernel.count(old) == 1, old
    edited = tool.variant_source(name)
    assert edited != kernel
    for _, new in tool.EDITS[name]:
        assert new == "" or new in edited


def test_k3_faults_are_named_variants():
    assert k3_variants.FAULTS and set(k3_variants.FAULTS) <= set(k3_variants.EDITS)


def test_warp_bwd_faults_are_named_variants():
    assert set(warp_bwd_variants.FAULTS) == {"no_sync_before_flush", "flush_store", "band_off_by_one"}
    assert set(warp_bwd_variants.FAULTS) <= set(warp_bwd_variants.EDITS)


def test_warp_fwd_faults_are_named_variants():
    assert set(warp_fwd_variants.FAULTS) == {"band_row_too_wide", "band_start_off_by_one",
                                             "band_short"}
    assert set(warp_fwd_variants.RACES) == {"no_copy_wait"}
    assert set(warp_fwd_variants.FAULTS + warp_fwd_variants.RACES) <= set(warp_fwd_variants.EDITS)


def test_k9_faults_are_named_variants():
    assert set(k9_variants.FAULTS) == {"frag_column_off_by_one", "bm_group_off",
                                       "last_slab_not_zero_filled"}
    assert set(k9_variants.RACES) == {"ring_no_wait"}
    assert set(k9_variants.FAULTS + k9_variants.RACES) <= set(k9_variants.EDITS)


#: (b, P, L, h, w, f, O) -> the plan of K8's bf16 kernels on an H100: at 64x64x64 the forward
#: in 128-pixel tiles with both n96 products of O = 192 and a band of 14 rows (R = 6), pass 1
#: in two passes of 32 channels with a 14-row band, pass 2 two parts an item and two flows a
#: block (448 blocks) with a 14-row band ring; at 32x32x96 three products and three pass-1 passes; at
#: 16x16x96 64-pixel tiles and two forward passes over O to fill the SMs, pass 2 the whole image
#: in its ring; f = 24 one 32-channel item and pass; the ragged 9x11 image, P < one tile. Past
#: the layer widths pass 1 fits shared memory by chunks of O: f=192, O=576 two chunks of the g
#: tile at two warpgroups; f=384, O=1152 four at one; O=1536 g streamed beside W^T; L=480 the
#: indices from global memory.
K8_PLANS = {
    "64x64x64": ((32, 4096, 13, 64, 64, 64, 192),
              dict(fpad=64, fwd_wg=2, fwd_onb=2, fwd_opasses=1, fwd_R=6, fwd_rows=14, fwd_tiles=32,
                   p1_wg=2, p1_passes=2, p1_ks=12, p1_R=6, p1_rows=14, p1_tiles=32, p1_gtile=1, p1_sidx=1, p2_nb=64,
                   p2_fpasses=1, p2_mt=2, p2_opasses=1, p2_os=200, p2_R=6, p2_rows=14, p2_parts=2,
                   p2_fl=2, fwd_smem=163840, p1_smem=146432, p2_smem=227840, fwd_blocks=1024,
                   p1_blocks=1024, p2_blocks=448)),
    "32x32x96": ((32, 1024, 13, 32, 32, 96, 288),
              dict(fpad=96, fwd_wg=2, fwd_onb=3, fwd_opasses=1, fwd_R=4, fwd_rows=12, fwd_tiles=8,
                   p1_wg=2, p1_passes=3, p1_ks=18, p1_R=4, p1_rows=12, p1_tiles=8, p1_gtile=1, p1_sidx=1, p2_nb=96,
                   p2_fpasses=1, p2_mt=3, p2_opasses=1, p2_os=296, p2_R=4, p2_rows=12, p2_parts=2,
                   p2_fl=1, fwd_smem=147456, p1_smem=150528, p2_smem=214272, fwd_blocks=256,
                   p1_blocks=256, p2_blocks=832)),
    "16x16x96": ((32, 256, 13, 16, 16, 96, 288),
              dict(fpad=96, fwd_wg=1, fwd_onb=2, fwd_opasses=2, fwd_R=4, fwd_rows=12, fwd_tiles=4,
                   p1_wg=1, p1_passes=3, p1_ks=18, p1_R=4, p1_rows=12, p1_tiles=4, p1_gtile=1, p1_sidx=1, p2_nb=96,
                   p2_fpasses=1, p2_mt=3, p2_opasses=1, p2_os=296, p2_R=4, p2_rows=16, p2_parts=2,
                   p2_fl=1, fwd_smem=86016, p1_smem=93696, p2_smem=189696, fwd_blocks=256,
                   p1_blocks=128, p2_blocks=832)),
    "f24": ((2, 256, 3, 16, 16, 24, 72),
              dict(fpad=32, fwd_wg=1, fwd_onb=1, fwd_opasses=1, fwd_R=4, fwd_rows=12, fwd_tiles=4,
                   p1_wg=1, p1_passes=1, p1_ks=5, p1_R=4, p1_rows=12, p1_tiles=4, p1_gtile=1, p1_sidx=1, p2_nb=32,
                   p2_fpasses=1, p2_mt=1, p2_opasses=1, p2_os=80, p2_R=4, p2_rows=16, p2_parts=4,
                   p2_fl=2, fwd_smem=36864, p1_smem=35328, p2_smem=66816, fwd_blocks=8,
                   p1_blocks=8, p2_blocks=16)),
    "ragged": ((2, 50, 3, 9, 11, 24, 72),
              dict(fpad=32, fwd_wg=1, fwd_onb=1, fwd_opasses=1, fwd_R=4, fwd_rows=9, fwd_tiles=1,
                   p1_wg=1, p1_passes=1, p1_ks=5, p1_R=4, p1_rows=9, p1_tiles=1, p1_gtile=1, p1_sidx=1, p2_nb=32,
                   p2_fpasses=1, p2_mt=1, p2_opasses=1, p2_os=80, p2_R=4, p2_rows=9, p2_parts=1,
                   p2_fl=2, fwd_smem=30976, p1_smem=29440, p2_smem=56832, fwd_blocks=2,
                   p1_blocks=2, p2_blocks=4)),
    "O576": ((32, 4096, 13, 64, 64, 192, 576),
              dict(fpad=192, fwd_wg=2, fwd_onb=3, fwd_opasses=2, fwd_R=2, fwd_rows=6, fwd_tiles=32,
                   p1_wg=2, p1_passes=6, p1_ks=36, p1_R=3, p1_rows=8, p1_tiles=32, p1_gtile=1,
                   p1_sidx=1, p2_nb=128, p2_fpasses=2, p2_mt=2, p2_opasses=3, p2_os=264, p2_R=1,
                   p2_rows=4, p2_parts=2, p2_fl=1, fwd_smem=221184, p1_smem=232448, p2_smem=201728,
                   fwd_blocks=2048, p1_blocks=1024, p2_blocks=4992)),
    "O1152": ((32, 4096, 13, 64, 64, 384, 1152),
              dict(fpad=384, fwd_wg=2, fwd_onb=3, fwd_opasses=4, fwd_R=0, fwd_rows=2, fwd_tiles=32,
                   p1_wg=1, p1_passes=12, p1_ks=72, p1_R=4, p1_rows=9, p1_tiles=64, p1_gtile=1,
                   p1_sidx=1, p2_nb=128, p2_fpasses=3, p2_mt=2, p2_opasses=5, p2_os=264, p2_R=1,
                   p2_rows=4, p2_parts=2, p2_fl=1, fwd_smem=172032, p1_smem=228864, p2_smem=201728,
                   fwd_blocks=4096, p1_blocks=2048, p2_blocks=12480)),
    "O1536": ((2, 256, 3, 16, 16, 32, 1536),
              dict(fpad=32, fwd_wg=1, fwd_onb=1, fwd_opasses=16, fwd_R=4, fwd_rows=12, fwd_tiles=4,
                   p1_wg=1, p1_passes=1, p1_ks=96, p1_R=4, p1_rows=12, p1_tiles=4, p1_gtile=0,
                   p1_sidx=1, p2_nb=32, p2_fpasses=1, p2_mt=3, p2_opasses=4, p2_os=392, p2_R=4,
                   p2_rows=16, p2_parts=4, p2_fl=2, fwd_smem=36864, p1_smem=126464, p2_smem=187136,
                   fwd_blocks=128, p1_blocks=8, p2_blocks=64)),
    "L480": ((2, 50, 480, 9, 11, 8, 16),
              dict(fpad=32, fwd_wg=1, fwd_onb=1, fwd_opasses=1, fwd_R=4, fwd_rows=9, fwd_tiles=1,
                   p1_wg=1, p1_passes=1, p1_ks=1, p1_R=4, p1_rows=9, p1_tiles=1, p1_gtile=1,
                   p1_sidx=0, p2_nb=32, p2_fpasses=1, p2_mt=1, p2_opasses=1, p2_os=24, p2_R=4,
                   p2_rows=9, p2_parts=1, p2_fl=2, fwd_smem=30976, p1_smem=11520, p2_smem=35328,
                   fwd_blocks=2, p1_blocks=2, p2_blocks=480)),
}


@pytest.mark.parametrize("case", list(K8_PLANS))
def test_k8_plan(case):
    args, want = K8_PLANS[case]
    got = k8_variants.plan(*args)
    assert got == want
    b, P, L, h, w, f, O = args
    assert got["fwd_onb"] * 96 * got["fwd_opasses"] >= O and got["fpad"] % 32 == 0
    assert got["p1_passes"] * 32 >= f and got["p2_nb"] * got["p2_fpasses"] >= f
    assert got["p2_mt"] * 128 * got["p2_opasses"] >= O
    assert got["fwd_rows"] <= h and got["p1_rows"] <= h and got["p2_rows"] <= h
    assert max(got["fwd_smem"], got["p1_smem"], got["p2_smem"]) <= k8_variants.H100_LIMITS[1]
    assert got["p2_parts"] * b == k8_variants.slices(b, P, L)


def test_k8_faults_are_named_variants():
    assert set(k8_variants.FAULTS) == {"tap_weight_off", "g_l_column_off_by_one", "band_slot_off",
                                       "w_rows_off"}
    assert set(k8_variants.RACES) == {"ring_no_wait"}
    assert set(k8_variants.FAULTS + k8_variants.RACES) <= set(k8_variants.EDITS)


@pytest.mark.parametrize("P,w,step,length,want", [(4096, 64, 128, 128, 2), (4096, 64, 64, 128, 2),
                                                   (1000, 32, 64, 128, 4), (50, 11, 64, 64, 5),
                                                   (400, 200, 64, 64, 2)])
def test_k8_max_span(P, w, step, length, want):
    r"""The rows a run of pixels spans, against a count over every run."""
    runs = [(k * step, min(k * step + length, P) - 1) for k in range(-(-P // step))]
    assert k8_variants.max_span(P, w, step, length) == want \
        == max(p1 // w - p0 // w + 1 for p0, p1 in runs)


#: (b, L, P, h, w, c) -> the plan of K9's bf16 kernels: at EF-TrajGRU's three layer shapes
#: 256-row blocks (two m64 tiles a warpgroup), Bm in registers and staged d_img slabs, one
#: channel pass and chunk, 6656 / 1664 / 416 forward blocks; c = 24 and c = 20 (padded to 24
#: by the wrapper) one pass of 32; the ragged image every fragment gathered; h % 8 != 0 d_img
#: gathered, the forward still in registers; c = 136 two passes of 128 in 128-row blocks and two
#: chunks; w = 200 d_A / d_Bm by the general kernel in two column chunks of 128, with f32
#: scratch for d_A's two parts; h = 512 the forward's A tile in two parts (so gathered); h =
#: 1024 in three, and d_A / d_Bm by the general kernel (the A tile too tall), in one part each.
K9_PLANS = {
    "64x64x64": ((32, 13, 4096, 64, 64, 64),
               dict(np=64, passes=1, mt=2, fwd_w=64, dimg_w=64, ny=4, hs=66, yc=64, yparts=1,
                    dab_n=64, kch=64, chunks=1, cs=72, yr=2, dab_general=0, xchunks=1,
                    fwd_smem=66560, dimg_smem=71680, dab_smem=100864, fwd_blocks=6656,
                    dimg_blocks=512, dab_blocks=13312, scratch=0)),
    "32x32x96": ((32, 13, 1024, 32, 32, 96),
               dict(np=96, passes=1, mt=2, fwd_w=32, dimg_w=32, ny=8, hs=34, yc=32, yparts=1,
                    dab_n=32, kch=96, chunks=1, cs=104, yr=1, dab_general=0, xchunks=1,
                    fwd_smem=66560, dimg_smem=73728, dab_smem=59904, fwd_blocks=1664,
                    dimg_blocks=128, dab_blocks=3328, scratch=0)),
    "16x16x96": ((32, 13, 256, 16, 16, 96),
               dict(np=96, passes=1, mt=2, fwd_w=16, dimg_w=16, ny=16, hs=18, yc=16, yparts=1,
                    dab_n=16, kch=96, chunks=1, cs=104, yr=1, dab_general=0, xchunks=1,
                    fwd_smem=58368, dimg_smem=69632, dab_smem=43520, fwd_blocks=416,
                    dimg_blocks=32, dab_blocks=832, scratch=0)),
    "c24": ((2, 3, 256, 16, 16, 24),
               dict(np=32, passes=1, mt=2, fwd_w=16, dimg_w=16, ny=16, hs=18, yc=16, yparts=1,
                    dab_n=16, kch=32, chunks=1, cs=40, yr=1, dab_general=0, xchunks=1,
                    fwd_smem=25600, dimg_smem=36864, dab_smem=18944, fwd_blocks=6, dimg_blocks=2,
                    dab_blocks=12, scratch=0)),
    "ragged": ((2, 3, 50, 9, 11, 24),
               dict(np=32, passes=1, mt=2, fwd_w=0, dimg_w=0, ny=0, hs=14, yc=12, yparts=1,
                    dab_n=16, kch=32, chunks=1, cs=40, yr=1, dab_general=0, xchunks=1,
                    fwd_smem=23552, dimg_smem=16384, dab_smem=17920, fwd_blocks=2, dimg_blocks=2,
                    dab_blocks=4, scratch=0)),
    "h6": ((2, 3, 96, 6, 16, 64),
               dict(np=64, passes=1, mt=2, fwd_w=16, dimg_w=0, ny=0, hs=10, yc=8, yparts=1,
                    dab_n=16, kch=64, chunks=1, cs=72, yr=1, dab_general=0, xchunks=1,
                    fwd_smem=37888, dimg_smem=32768, dab_smem=29184, fwd_blocks=4, dimg_blocks=2,
                    dab_blocks=6, scratch=0)),
    "c136": ((2, 2, 200, 8, 32, 136),
               dict(np=128, passes=2, mt=1, fwd_w=32, dimg_w=32, ny=4, hs=10, yc=8, yparts=1,
                    dab_n=32, kch=128, chunks=2, cs=152, yr=1, dab_general=0, xchunks=1,
                    fwd_smem=68096, dimg_smem=88064, dab_smem=74240, fwd_blocks=16, dimg_blocks=8,
                    dab_blocks=8, scratch=0)),
    "w200": ((1, 1, 400, 2, 200, 8),
               dict(np=16, passes=1, mt=2, fwd_w=0, dimg_w=0, ny=0, hs=6, yc=4, yparts=1,
                    dab_n=128, kch=16, chunks=1, cs=24, yr=1, dab_general=1, xchunks=2,
                    fwd_smem=11264, dimg_smem=8192, dab_smem=22528, fwd_blocks=2, dimg_blocks=2,
                    dab_blocks=4, scratch=80800)),
    "tall": ((1, 1, 128, 512, 16, 8),
               dict(np=16, passes=1, mt=2, fwd_w=0, dimg_w=16, ny=16, hs=514, yc=436, yparts=2,
                    dab_n=16, kch=16, chunks=1, cs=24, yr=1, dab_general=0, xchunks=1,
                    fwd_smem=232448, dimg_smem=28672, dab_smem=139776, fwd_blocks=1,
                    dimg_blocks=32, dab_blocks=1, scratch=0)),
    "h1024": ((2, 3, 64, 1024, 16, 8),
               dict(np=16, passes=1, mt=2, fwd_w=0, dimg_w=16, ny=16, hs=1026, yc=436, yparts=3,
                    dab_n=16, kch=16, chunks=1, cs=24, yr=1, dab_general=1, xchunks=1,
                    fwd_smem=232448, dimg_smem=28672, dab_smem=8192, fwd_blocks=2, dimg_blocks=128,
                    dab_blocks=4, scratch=0)),
}


@pytest.mark.parametrize("case", list(K9_PLANS))
def test_k9_plan(case):
    args, want = K9_PLANS[case]
    got = k9_variants.plan(*args)
    assert got == want
    b, L, P, h, w, c = args
    assert got["np"] * got["passes"] >= c > got["np"] * (got["passes"] - 1)
    assert got["kch"] * got["chunks"] >= c and got["dab_n"] * got["xchunks"] >= w
    assert got["yc"] * got["yparts"] >= h > got["yc"] * (got["yparts"] - 1)
    assert max(got["fwd_smem"], got["dimg_smem"], got["dab_smem"]) <= k9_variants.SMEM_MAX


def test_k9_l2_bytes_at_64x64():
    r"""PERF.md's count: 3.49 GB of image slabs (forward), 7.20 GB of g, Bm and A slabs
    (d_img) and 6.98 GB of image rows (d_A / d_Bm) per call at b=32, L=13, 64x64x64."""
    assert k9_variants.l2_bytes(32, 13, 4096, 64, 64, 64) == dict(
        fwd=6656 * 64 * 64 * 64 * 2, dimg=512 * 832 * 64 * (64 + 64 + 4) * 2,
        dab=13312 * 64 * 64 * 64 * 2)


@pytest.mark.parametrize("c", [20, 24, 64])
def test_bf16_contract_operands_pad_channels_and_align(c):
    r"""The bf16 kernels read 16-byte vectors: channels padded with zeros to a
    multiple of 8, a view that starts off a 16-byte boundary copied."""
    base = torch.arange(2 * 3 * c + 1, dtype=torch.float32).bfloat16()
    img = base[1:].view(2, 3, c)                  # 2 bytes past the storage's start
    A = torch.ones(2, 5, dtype=torch.bfloat16)
    A2, img2 = _bf16_contract_operands(A, img)
    assert A2 is A
    assert img2.data_ptr() % 16 == 0 and img2.shape == (2, 3, -(-c // 8) * 8)
    assert torch.equal(img2[..., :c], img) and not img2[..., c:].any()


#: (b, P, h, w, c, bf16) -> what the forward's tiling must hold on an H100: bands of
#: 20 / 12 / 10 rows in 160 / 72 / 30 KB and 256 blocks at EF-TrajGRU's three layer shapes
#: in bf16, two vectors a lane; two passes of 32 channels in f32 at 64x64x64; one vector a
#: lane where c / V is odd; R shrunk and no band where not one row of 16 bytes a pixel fits;
#: a band placed by pixel index where P != h*w.
FWD_PLANS = {
    "64x64x64-bf16": ((32, 4096, 64, 64, 64, True),
                      dict(tile_px=512, tiles=8, R=6, rows=20, cw=64, passes=1, vpl=2, V=8,
                           smem=163840, threads=1024)),
    "32x32x96-bf16": ((32, 1024, 32, 32, 96, True),
                      dict(tile_px=128, tiles=8, R=4, rows=12, cw=96, passes=1, vpl=2, V=8,
                           smem=73728, threads=512)),
    "16x16x96-bf16": ((32, 256, 16, 16, 96, True),
                      dict(tile_px=32, tiles=8, R=4, rows=10, cw=96, passes=1, vpl=2, V=8,
                           smem=30720, threads=512)),
    "64x64x64-f32": ((32, 4096, 64, 64, 64, False),
                     dict(tile_px=512, tiles=8, R=6, rows=20, cw=32, passes=2, vpl=2, V=4,
                          smem=163840, threads=1024)),
    "32x32x96-f32": ((32, 1024, 32, 32, 96, False),
                     dict(tile_px=128, tiles=8, R=4, rows=12, cw=96, passes=1, vpl=2, V=4,
                          smem=147456, threads=1024)),
    "c20-bf16": ((2, 2560, 40, 64, 20, True),
                 dict(tile_px=64, tiles=40, R=6, rows=13, cw=20, passes=1, vpl=1, V=4,
                      smem=33280, threads=512)),
    "no-band": ((1, 30000, 2, 15000, 8, True),
                dict(tile_px=15000, tiles=2, R=4, rows=0, cw=8, passes=1, vpl=1, V=8,
                     smem=0, threads=512)),
    "P-not-hw": ((2, 130, 24, 40, 16, False),
                 dict(tile_px=40, tiles=4, R=4, rows=9, cw=16, passes=1, vpl=2, V=4,
                      smem=23040, threads=512)),
}


@pytest.mark.parametrize("case", list(FWD_PLANS))
def test_warp_fwd_plan_on_an_h100(case):
    args, want = FWD_PLANS[case]
    got = warp_fwd_variants.plan(*args)
    assert got == want
    b, P, h, w, c, bf16 = args
    assert got["smem"] <= warp_fwd_variants.H100_LIMITS[1]
    assert got["passes"] * got["cw"] >= c > (got["passes"] - 1) * got["cw"]
    assert (got["cw"] // got["V"]) % got["vpl"] == 0


def _out_of_band_loop(iy, ix, h, w, geom):
    r"""The count of :func:`warp_bwd_variants.out_of_band_share`, one tap at a time."""
    outside = total = 0
    b, P, L = iy.shape
    for bi, p, l in itertools.product(range(b), range(P), range(L)):
        p0 = p // geom["tile_px"] * geom["tile_px"]
        row0 = max(0, min(p0 // w - geom["R"], h - geom["rows"]))
        y0, x0 = math.floor(iy[bi, p, l]), math.floor(ix[bi, p, l])
        for y, x in itertools.product((y0, y0 + 1), (x0, x0 + 1)):
            if 0 <= y < h and 0 <= x < w:
                total += 1
                outside += not row0 <= y < row0 + geom["rows"]
    return outside, total


@pytest.mark.parametrize("h,w,P,tile_px,R,rows", [(10, 6, 60, 12, 2, 6), (10, 6, 60, 6, 1, 3),
                                                   (7, 5, 23, 10, 4, 7), (9, 4, 36, 8, 2, 0)],
                         ids=["band", "one-row-tiles", "ragged-P-whole-image", "no-window"])
def test_out_of_band_share_counts_each_tap(h, w, P, tile_px, R, rows):
    rng = np.random.default_rng(3)
    b, L = 2, 3
    iy = rng.normal(0.0, 3.0, (b, P, L)) + np.repeat(np.arange(P) // w, L).reshape(1, P, L)
    ix = rng.uniform(-2.0, w + 1.0, (b, P, L))
    iy, ix = (torch.from_numpy(a.astype(np.float32)) for a in (iy, ix))
    geom = dict(tile_px=tile_px, R=R, rows=rows)
    got = warp_bwd_variants.out_of_band_share(iy, ix, h, w, geom)
    assert got == _out_of_band_loop(iy.numpy(), ix.numpy(), h, w, geom)
    assert 0 < got[1] and (got[0] == got[1] if rows == 0 else got[0] < got[1])


def test_a_stale_anchor_raises():
    with pytest.raises(ValueError, match="occurs 0 times"):
        k3_variants.apply_edits("convlstm_scan.cu", {"stale": [("no such text", "x")]}, "stale")
