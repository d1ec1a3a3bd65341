"""Mutation check of the card tests of K2 (the W8A8 GEMM and its row
quantizer), K3 and K6 (decode cross-attention over int8 and packed int4
K/V, the int8 and int4 instances of K11's kernel), K4 (the same over bf16
K/V, its bf16 instance), K7 (int8-dot encoder attention on wgmma,
resident and streamed), K1 and K8 (encoder
attention, strided and packed heads), K5 (tiled flash attention), K9
(head pairs) and K10 (the persistent, pipelined form), all five on the
wgmma attention core, K11 (the slab-fed decode cross-attention over int8
K/V), K13 (cache column write) and K14 (the "w8a8" decoder's int8 x int8
cross-attention): each case breaks the kernel in a copy
of the package under a temporary directory, where the copy builds its own
kernel library, and the card tests of tests/test_torch_kernels_cuda.py
must then fail on the kernel's values. Each edit names the exact text it
replaces, so a case fails loudly once the source no longer holds it.

The kernels have no CPU mode, so every case carries the `cuda` marker and
skips without a card:

    python -m pytest --noconftest -m cuda -s tests/test_torch_kernel_mutations.py
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
Q8_SRC = "spittle_tpu_torch/csrc/fullkv_attention_q8.cu"
FULLKV_SRC = "spittle_tpu_torch/csrc/fullkv_attention.cu"
# K1, K5, K8, K9 and K10 are instances of the attention core; their masks,
# operand addressing and (K10) cross-item state live there.
CORE_SRC = "spittle_tpu_torch/csrc/attention_sm90.cuh"
CACHE_SRC = "spittle_tpu_torch/csrc/cache_col_write.cu"
MH_SRC = "spittle_tpu_torch/csrc/decode_cross_attention_mh.cu"
GEMM_SRC = "spittle_tpu_torch/csrc/w8a8_gemm.cu"
W8A8_SRC = "spittle_tpu_torch/csrc/decode_cross_attention_w8a8.cu"
CARD_TESTS = "tests/test_torch_kernels_cuda.py"

# name -> (pytest -k selection in CARD_TESTS, [(file, old text, new text)])
MUTATIONS = {
    # Pad columns enter the row max: K3 and K6 (int8 and int4 instances of
    # K11's kernel) read the pad columns' scales and keep their scores.
    "mask_after_max": ("quant_kernel_matches and 1300", [
        (MH_SRC, "ksc[j] = live[j] ? ks[at] : 0.f;", "ksc[j] = ks[at];"),
        (MH_SRC, "sc[r][j] = live[j] ? sj : -INFINITY;", "sc[r][j] = sj;"),
    ]),
    # K6: nibbles read as unsigned values, 0..15, no sign extension.
    "nibble_unsigned": ("quant_kernel_matches and int4", [
        (MH_SRC, "const uint32_t u = w ^ 0x88888888u;", "const uint32_t u = w;"),
        (MH_SRC, "- 8388616.f", "- 8388608.f"),
    ]),
    # K7: V's per-position scales not folded into P (pv = p), in the pass
    # that takes P's scale and in the pass that quantizes P.
    "q8_vs_not_folded": ("q8_kernel_matches and 1500", [
        (Q8_SRC, "const float pv = __fmul_rn(pr, e ? vs2.y : vs2.x);",
         "const float pv = pr;"),
    ]),
    # K7: P's scale sp fixed at 1 instead of mp/127.
    "q8_sp_fixed": ("q8_kernel_matches and 1500", [
        (Q8_SRC, "sp[hr] = mp[hr] > 0.f ? __fdiv_rn(mp[hr], 127.0f) : 1.0f;",
         "sp[hr] = 1.0f;"),
    ]),
    # K7: the kv_len mask dropped from p, so keys from kv_len to Tk enter
    # l, mp and PV.
    "q8_kv_len_mask_dropped": ("q8_kernel_matches and (1300 or 1900)", [
        (Q8_SRC, "const float pr = !kEdge || col < p.kv_len ? expf(s - m[hr]) : 0.f;",
         "const float pr = expf(s - m[hr]);"),
    ]),
    # K7: Vt written in key order instead of PV's operand order, so each
    # P code meets another key's V.
    "q8_pv_order_identity": ("q8_kernel_matches and 1500", [
        (Q8_SRC, "return (r & ~15) | (4 * ((r & 7) >> 1) + 2 * ((r >> 3) & 1) + (r & 1));",
         "return r;"),
    ]),
    # K7: pass 3 loads the neighbouring key tile's Vt (j ^ 1), on the
    # streamed form's shape.
    "q8_v_tile_swapped": ("q8_kernel_matches and 4096", [
        (Q8_SRC, "sm::tma_load_3d(st + kVOffset, &tm_v, full(s), j * kBK, 0, bh);",
         "sm::tma_load_3d(st + kVOffset, &tm_v, full(s), (j ^ 1) * kBK, 0, bh);"),
    ]),
    # K5: attention_reference's Tk - Tq offset put into the causal rule,
    # which K5 does not have; it shows only where Tq != Tk.
    "flash_causal_offset": ("flash_kernel_matches and 200-500-500", [
        (CORE_SRC, "(p.causal && col > row)) s[i] = kNegBig;",
         "(p.causal && col > row + (p.Tk - p.Tq))) s[i] = kNegBig;"),
    ]),
    # K5: the key mask taken against Tk instead of kv_len, so keys from
    # kv_len to Tk enter the softmax.
    "flash_kv_len_mask": ("flash_kernel_matches and 256-384-300", [
        (CORE_SRC, "if (col >= p.kv_len || (p.causal", "if (col >= p.Tk || (p.causal"),
    ]),
    # K1: the same mask mutant in the core, against K1's card test at
    # kv_len 290 of 300.
    "fullkv_kv_len_mask": ("fullkv_kernel_matches and 290", [
        (CORE_SRC, "if (col >= p.kv_len || (p.causal", "if (col >= p.Tk || (p.causal"),
    ]),
    # K8: the packed layout's head stride passed as T*64 (a contiguous
    # [B, H, T, 64] tensor's) instead of 64, for q and for k/v.
    "packed_head_stride": ("packed_kernel_matches and not pair", [
        (FULLKV_SRC, "const long long qs[3] = {Tq * row, kD, row}, ks[3] = {Tk * row, kD, row};",
         "const long long qs[3] = {Tq * row, Tq * kD, row}, ks[3] = {Tk * row, Tk * kD, row};"),
    ]),
    # K4 (the bf16 instance of K11's kernel): p = exp(s) without the
    # chunk's max, so the combine pass weighs each chunk by e^m_c once too
    # often.
    "k4_chunk_max_not_subtracted": ("k4_on_decoder_layouts and 1500-1500", [
        (MH_SRC, "const float p = live[j] ? expf(sc[r][j] - mx) : 0.f;",
         "const float p = live[j] ? expf(sc[r][j]) : 0.f;"),
    ]),
    # K4, the decoder's padded rows: the TMA map's row pitch taken as 2 *
    # Tk rounded down to 16 bytes instead of the stride.
    "k4_map_pitch_rounded_down": ("k4_on_decoder_layouts and padded and 1500", [
        (MH_SRC, "const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldb)};",
         "const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Tk * sizeof(E)) & ~15ull};"),
    ]),
    # K4: the V words past kv_len of the last item not zeroed, so the NaN
    # and inf there reach PV (0 * inf).
    "k4_tail_unmasked": ("k4_on_decoder_layouts and 1300", [
        (MH_SRC, "              w0 &= keep;\n              w1 &= keep;\n", ""),
    ]),
    # K9: warpgroup 1 reads head h0's V box instead of its own head's.
    "pair_v_box": ("packed_kernel_matches and pair", [
        (CORE_SRC, "const uint32_t v_off = (P::kKvBoxes + w * P::kHeadSteps) * L::kBoxBytes;",
         "const uint32_t v_off = (P::kKvBoxes + 0 * P::kHeadSteps) * L::kBoxBytes;"),
    ]),
    # K10: l and m not reset where a block moves on to its next work item,
    # so a row's sum carries the previous item's rows; only blocks that
    # walk several items ([2, 20, 1500]: 480 items).
    "pipe_row_state_carried": ("pipe_kernel_matches and 2-20-1500-1500", [
        (CORE_SRC, "for (int hr = 0; hr < 2; ++hr) l[hr] = 0.f, m[hr] = kNegBig;",
         "for (int hr = 0; hr < 2; ++hr) (void)hr;"),
    ]),
    # K11, TMA path: K's box one head further down the slab.
    "mh_box_head_offset": ("mh_kernel_matches and 1536", [
        (MH_SRC, "tma_load_2d(sm::smem_u32(st), &tm_k, full(s), it.t0, row0);",
         "tma_load_2d(sm::smem_u32(st), &tm_k, full(s), it.t0, row0 + kD);"),
    ]),
    # K3 (on K11's kernel), the decoder's padded rows: the TMA map's row
    # pitch taken as Tk rounded down to 16 bytes instead of the stride.
    "k3_map_pitch_rounded_down": ("k3_on_decoder_layouts and padded", [
        (MH_SRC, "const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldb)};",
         "const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Tk * sizeof(E)) & ~15ull};"),
    ]),
    # K2: a row's sx read from its neighbour's (the last row of an odd M
    # keeps its own, so that no read passes sx's end).
    "gemm_sx_neighbour_row": ("w8a8_kernel_at_encoder_shapes", [
        (GEMM_SRC, "sxr[i] = row < M ? sx[row] : 0.f;",
         "sxr[i] = row < M ? sx[min(row ^ 1, M - 1)] : 0.f;"),
    ]),
    # K2: the ring's second K slice of every tile skipped, slice 0's A box
    # loaded again in its place.
    "gemm_slice_skipped": ("w8a8_kernel_at_encoder_shapes", [
        (GEMM_SRC, "sm::tma_load_2d(stage(g), &tm_a, full(s), j * kBK, ti.m0);",
         "sm::tma_load_2d(stage(g), &tm_a, full(s), (j == 1 ? 0 : j) * kBK, ti.m0);"),
    ]),
    # K2: the bias added before the scales instead of after them.
    "gemm_bias_before_scale": ("w8a8_kernel_at_encoder_shapes", [
        (GEMM_SRC,
         "float v = __fmaf_rn(__fmul_rn(static_cast<float>(acc), s_x), s_w, b);",
         "float v = __fmul_rn(__fmul_rn(static_cast<float>(acc) + b, s_x), s_w);"),
    ]),
    # K2's quantizer: x / s as a multiply by the reciprocal of s.
    "quantizer_reciprocal": ("w8a8_quantizer_bytes_equal_plain", [
        (GEMM_SRC, "const float v = rintf(at(4 * i + j) / s);",
         "const float v = rintf(at(4 * i + j) * (1.0f / s));"),
    ]),
    # K14: q's codes rounded half away from zero (roundf) instead of half
    # to even, on q rows whose entries sit on .5.
    "w8a8_round_half_away": ("k14_kernel_matches_plain_on_ties", [
        (W8A8_SRC, "rintf(to_f32(qr[d]) / scale)", "roundf(to_f32(qr[d]) / scale)"),
    ]),
    # K14: the scores past kv_len kept (the mask dropped), so the pad's
    # huge scores set the row max and the real positions' exponentials
    # vanish.
    "w8a8_mask_after_max": ("k14_kernel_matches_plain and kv1300", [
        (W8A8_SRC, "return tt < live ? sc : -INFINITY;", "return sc;"),
    ]),
    # K14: each row's scores scaled by its neighbour row's q scale.
    "w8a8_neighbour_sq": ("k14_kernel_matches_plain and R4-T1500-padded", [
        (W8A8_SRC, "score(acc[r][j], sq[r], kss[tt + j], tt + j, live)",
         "score(acc[r][j], sq[r ^ 1], kss[tt + j], tt + j, live)"),
    ]),
    # K14: the K and V slabs' row pitch read as T (1500) instead of the
    # decoder's padded pitch (1504); the loads then take 4-byte chunks.
    "w8a8_pitch_as_t": ("k14_kernel_matches_plain and R1-T1500-padded", [
        (W8A8_SRC, "p.k_ld = k_ld;", "p.k_ld = Tk;"),
        (W8A8_SRC, "p.v_ld = v_ld;", "p.v_ld = Tk;"),
    ]),
    # K14's cluster: each CTA exponentiates against its own slice's max
    # instead of the cluster's row max.
    "w8a8_local_max": ("k14_kernel_matches_plain and R1-T1500-padded", [
        (W8A8_SRC, "m = fmaxf(m, red_m[i * RT + r]);", "m = fmaxf(m, red_m[rank * RT + r]);"),
    ]),
    # K14's cluster: each CTA takes P's scale from its own slice's
    # max(p * vs) instead of the cluster's.
    "w8a8_local_pv_max": ("k14_kernel_matches_plain and R1-T1500-padded", [
        (W8A8_SRC, "pa = fmaxf(pa, red_p[i * RT + r]);",
         "pa = fmaxf(pa, red_p[rank * RT + r]);"),
    ]),
    # K14's cluster: rank 0's int32 partial left out of the combine's sum.
    "w8a8_partial_left_out": ("k14_kernel_matches_plain and R1-T1500-padded", [
        (W8A8_SRC, "for (int peer = 0; peer < C; ++peer)",
         "for (int peer = 1; peer < C; ++peer)"),
    ]),
    # K13 (and K12, the same body): a neighbouring position written.
    "cache_neighbour_column": ("cache_col_write_matches", [
        (CACHE_SRC, "dst[r * row_stride + pos * pos_stride + j] = src[i];",
         "dst[r * row_stride + (pos > 0 ? pos - 1 : 1) * pos_stride + j] = src[i];"),
    ]),
    # K13 (and K12): the position rounded down to its 16-byte granule, so
    # the element lands up to 7 positions off.
    "cache_pos_granule_aligned": ("cache_col_write_at_sector_edges", [
        (CACHE_SRC, "dst[r * row_stride + pos * pos_stride + j] = src[i];",
         "dst[r * row_stride + (pos & ~7) * pos_stride + j] = src[i];"),
    ]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_card_tests_fail_on_mutant(cuda, tmp_path, name):
    select, edits = MUTATIONS[name]
    shutil.copytree(REPO / "spittle_tpu_torch", tmp_path / "spittle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "tests").mkdir()
    shutil.copy(REPO / CARD_TESTS, tmp_path / CARD_TESTS)
    for rel, old, new in edits:
        path = tmp_path / rel
        text = path.read_text()
        assert old in text, f"{name}: {old!r} is no longer in {rel}"
        path.write_text(text.replace(old, new))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q", "-x",
         "-p", "no:cacheprovider", CARD_TESTS, "-k", select],
        cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(tmp_path)})
    detail = [ln.strip() for ln in res.stdout.splitlines()
              if "Greatest absolute difference" in ln or "Mismatched elements" in ln
              or "not close to its plain version" in ln]
    print(f"{name}: card tests exit {res.returncode}; " + "; ".join(detail[:2]))
    # Exit 1 with a value mismatch: the mutant built, ran and was caught.
    # A build or collection error would fail for another reason.
    caught = ("Tensor-likes are not close" in res.stdout
              or "Tensor-likes are not equal" in res.stdout
              or "not close to its plain version" in res.stdout)
    assert res.returncode == 1 and caught, \
        res.stdout[-4000:] + res.stderr[-2000:]
