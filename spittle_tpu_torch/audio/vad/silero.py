"""Silero VAD v4 forward pass in PyTorch, batched over streams (port of
spittle_tpu/audio/vad/silero.py).

The network (the bundled weights' 16 kHz branch):
  reflect-pad 96 -> conv(258 filters, k=256, stride 64)  # STFT as a conv
  magnitude = sqrt(re^2 + im^2)                           # [B, 129, T]
  spect = log(mag * 2^20 + 1); norm = spect - smoothed global mean
  concat(mag, norm) -> depthwise-separable conv encoder (16/32/32/64,
  three stride-2 1x1 convs) -> 2-layer LSTM(64) -> 1x1 conv -> sigmoid
  -> mean over time.

Everything runs on the device of the weights (audio given as numpy goes
there), in full f32 (TF32 off): the 0.3 threshold turns a small drift into
a flipped frame. The LSTM is one `nn.LSTM(64, 64, num_layers=2)` call over
the whole sequence (cuDNN on the card), not a Python loop of cells: a
10-minute recording is 20,000 steps. It runs in f64 and its outputs are
rounded to f32: over 20,000 steps cuDNN's f32 LSTM drifts 7.4e-5 in
probability from an f64 evaluation, where the CPU's f32 LSTM drifts 1.5e-6
(probes/silero_lstm.py on an H100).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.ops import full_f32

# Bundled weights: the Silero v4 tensors as package data (the same file as
# the reference package's config/data/models/silero_vad_v4.npz).
BUNDLED_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "silero_vad_v4.npz",
)
DEFAULT_MODEL_PATH = BUNDLED_NPZ

FRAME_SAMPLES_16K = 480  # 30 ms
LSTM_HIDDEN = 64  # state: [2, 2, B, 64] (h/c, layer, batch, hidden)
# The shortest window the reflect pads are defined for: torch's reflect
# pad needs a pad shorter than the padded length (96 < N for the STFT pad,
# 3 < N // 64 frames for the mean's), where jnp.pad reflects again.
MIN_SAMPLES = 256
# ONNX stores the LSTM gates as (i, o, f, c); nn.LSTM wants (i, f, g, o).
_GATE_ORDER = (0, 2, 3, 1)


def load_silero_params(path: Optional[str] = None, branch: str = "16k",
                       device="cuda") -> Dict:
    """Silero v4 weights on `device` ("cuda" by default; raises without a
    card): the bundled .npz by default; any path that does not end in
    .npz is read as the .onnx graph, whose `branch` ("16k" or "8k") is
    taken."""
    if path is None:
        path = BUNDLED_NPZ
    if path.endswith(".npz"):
        tree = _params_from_npz(path)
    else:
        tree = _params_from_onnx(path, branch)
    return silero_params_from_jax(tree, device=device)


def _params_from_npz(path: str) -> Dict:
    """The bundled .npz -> the reference's nested tree of numpy arrays."""
    flat = dict(np.load(path))
    params: Dict = {"blocks": [], "between": [], "lstm": []}
    for key in sorted(flat):
        parts = key.split(".")
        node = params
        for i, part in enumerate(parts[:-1]):
            if part.isdigit():
                idx = int(part)
                while len(node) <= idx:
                    node.append({})
                node = node[idx]
            else:
                nxt = parts[i + 1]
                default: object = [] if nxt.isdigit() else {}
                if isinstance(node, dict):
                    node = node.setdefault(part, default)
        node[parts[-1]] = flat[key]
    return params


# The anonymous initializers of each sample-rate branch, in the order
# (inter-block 1x1 convs: w, b x 4; LSTM layers: W, R, B x 2). They are
# the same in the zero-state and carried-state subgraphs.
_ONNX_ANON = {
    "16k": ("1110", "1111", "1113", "1114", "1116", "1117", "1119", "1120",
            "343", "345", "347", "415", "417", "419"),
    "8k": ("1122", "1123", "1125", "1126", "1128", "1129", "1131", "1132",
           "833", "835", "837", "905", "907", "909"),
}


def _params_from_onnx(path: str, branch: str = "16k") -> Dict:
    """One sample-rate branch of the Silero v4 .onnx graph -> the
    reference's nested tree of numpy arrays: the initializers of the
    top-level If's then_branch (16k) or else_branch (8k), and of the Ifs
    nested in it, under their model.* / model_8k.* and numbered names."""
    from spittle_tpu_torch.io.onnx_proto import load_onnx

    g = load_onnx(path)
    if_node = next(n for n in g.nodes if n.op_type == "If")
    sub = if_node.attr("then_branch" if branch == "16k" else "else_branch")
    pool = dict(g.initializers)
    pool.update(sub.initializers)
    for n in sub.nodes:
        if n.op_type == "If":
            for br in ("then_branch", "else_branch"):
                pool.update(n.attr(br).initializers)
    prefix = "model." if branch == "16k" else "model_8k."

    def p(name):
        return np.asarray(pool[prefix + name], dtype=np.float32)

    (c0w, c0b, c1w, c1b, c2w, c2b, c3w, c3b,
     l0w, l0r, l0b, l1w, l1r, l1b) = (
        np.asarray(pool[k], dtype=np.float32) for k in _ONNX_ANON[branch])
    params = {
        "stft_basis": p("feature_extractor.forward_basis_buffer"),
        "norm_filter": p("adaptive_normalization.filter_"),
        "first": {
            "dw_w": p("first_layer.0.dw_conv.0.weight"),
            "dw_b": p("first_layer.0.dw_conv.0.bias"),
            "pw_w": p("first_layer.0.pw_conv.0.weight"),
            "pw_b": p("first_layer.0.pw_conv.0.bias"),
            "proj_w": p("first_layer.0.proj.weight"),
            "proj_b": p("first_layer.0.proj.bias"),
        },
        "blocks": [],
        "between": [{"w": c0w, "b": c0b}, {"w": c1w, "b": c1b},
                    {"w": c2w, "b": c2b}, {"w": c3w, "b": c3b}],
        "lstm": [{"w": l0w[0], "r": l0r[0], "b": l0b[0]},
                 {"w": l1w[0], "r": l1r[0], "b": l1b[0]}],
        "head_w": p("decoder.decoder.1.weight"),
        "head_b": p("decoder.decoder.1.bias"),
    }
    for enc in ("3", "7", "11"):
        blk = {
            "dw_w": p(f"encoder.{enc}.0.dw_conv.0.weight"),
            "dw_b": p(f"encoder.{enc}.0.dw_conv.0.bias"),
            "pw_w": p(f"encoder.{enc}.0.pw_conv.0.weight"),
            "pw_b": p(f"encoder.{enc}.0.pw_conv.0.bias"),
        }
        if prefix + f"encoder.{enc}.0.proj.weight" in pool:
            blk["proj_w"] = p(f"encoder.{enc}.0.proj.weight")
            blk["proj_b"] = p(f"encoder.{enc}.0.proj.bias")
        params["blocks"].append(blk)  # encoder.7: identity residual
    return params


def silero_params_from_jax(tree: Dict, device="cuda") -> Dict:
    """The reference's Silero tree (numpy or JAX arrays) -> the port's
    tensors on `device`. The two LSTM layers become one nn.LSTM: the
    ONNX gate rows (i, o, f, c) are permuted to torch's (i, f, g, o), and
    the ONNX bias [Wb; Rb] splits into bias_ih and bias_hh."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def conv(d):
        return {k: t(v) for k, v in d.items()}

    lstm = nn.LSTM(LSTM_HIDDEN, LSTM_HIDDEN, num_layers=len(tree["lstm"]),
                   device="meta", dtype=torch.float64).to_empty(device=dev)
    h = LSTM_HIDDEN
    rows = np.concatenate([np.arange(g * h, (g + 1) * h) for g in _GATE_ORDER])
    with torch.no_grad():  # the f32 weights, exactly, in f64
        for li, lp in enumerate(tree["lstm"]):
            w, r, b = (np.asarray(lp[k], np.float32) for k in ("w", "r", "b"))
            getattr(lstm, f"weight_ih_l{li}").copy_(t(w[rows]))
            getattr(lstm, f"weight_hh_l{li}").copy_(t(r[rows]))
            getattr(lstm, f"bias_ih_l{li}").copy_(t(b[: 4 * h][rows]))
            getattr(lstm, f"bias_hh_l{li}").copy_(t(b[4 * h :][rows]))
    lstm.requires_grad_(False)
    lstm.flatten_parameters()
    return {
        "stft_basis": t(tree["stft_basis"]),
        "norm_filter": t(tree["norm_filter"]),
        "first": conv(tree["first"]),
        "blocks": [conv(b) for b in tree["blocks"]],
        "between": [conv(b) for b in tree["between"]],
        "lstm": lstm,
        "head_w": t(tree["head_w"]),
        "head_b": t(tree["head_b"]),
    }


def _device(params: Dict) -> torch.device:
    return params["stft_basis"].device


def _on(params: Dict, x) -> torch.Tensor:
    """Audio or state onto the weights' device, as f32."""
    return torch.as_tensor(x, dtype=torch.float32, device=_device(params))


def _lstm(params: Dict, seq: torch.Tensor, state: torch.Tensor):
    """The 2-layer LSTM over seq [T, B, 64] from state [2, 2, B, 64], in f64
    (see the module's note); returns f32 (out [T, B, 64], (hn, cn))."""
    out, (hn, cn) = params["lstm"](seq.double(), (state[0].double(),
                                                  state[1].double()))
    return out.float(), (hn.float(), cn.float())


def _sep_block(x, blk):
    """Depthwise(k=5) -> relu -> pointwise, + (proj | identity), relu."""
    c = x.shape[1]
    h = F.relu(F.conv1d(x, blk["dw_w"], blk["dw_b"], padding=2, groups=c))
    h = F.conv1d(h, blk["pw_w"], blk["pw_b"])
    res = F.conv1d(x, blk["proj_w"], blk["proj_b"]) if "proj_w" in blk else x
    return F.relu(h + res)


def init_state(batch: int, device="cuda") -> torch.Tensor:
    return torch.zeros((2, 2, batch, LSTM_HIDDEN), dtype=torch.float32,
                       device=resolve_device(device))


def _conv_features(params: Dict, audio: torch.Tensor, strides) -> torch.Tensor:
    """Everything before the LSTM (frame-local): [N, frame] -> [N, T', 64]."""
    if audio.shape[-1] < MIN_SAMPLES:
        raise ValueError(
            f"Silero windows of {audio.shape[-1]} samples are not supported: "
            f"the port needs at least {MIN_SAMPLES} (its reflect pads must be "
            "shorter than what they pad)")
    x = F.pad(audio[:, None, :], (96, 96), mode="reflect")
    spec = F.conv1d(x, params["stft_basis"], stride=64)
    half = spec.shape[1] // 2
    mag = torch.sqrt(spec[:, :half] ** 2 + spec[:, half:] ** 2)
    spect = torch.log(mag * 1048576.0 + 1.0)
    mean = spect.mean(dim=1, keepdim=True)
    mean_pad = F.pad(mean, (3, 3), mode="reflect")
    smoothed = F.conv1d(mean_pad, params["norm_filter"])
    norm = spect - smoothed.mean(dim=-1, keepdim=True)
    h = torch.cat([mag, norm], dim=1)
    h = _sep_block(h, params["first"])
    for betw, blk, stride in zip(params["between"][:3], params["blocks"], strides):
        h = F.relu(F.conv1d(h, betw["w"], betw["b"], stride=stride))
        h = _sep_block(h, blk)
    last = params["between"][3]
    h = F.relu(F.conv1d(h, last["w"], last["b"], stride=strides[3]))
    return h.transpose(1, 2)  # [N, T', 64]


def silero_forward(
    params: Dict,
    audio,
    state,
    strides: Tuple[int, ...] = (2, 2, 2, 1),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One VAD step on a batch of equal-length windows.

    audio: [B, N] float32 (N >= 256; typically 480 = one 30 ms frame).
    state: [2, 2, B, 64] (h/c, layer, batch, hidden); zeros at stream start.
    strides: inter-block conv strides: (2, 2, 2, 1) for the 16 kHz branch,
    (2, 2, 1, 1) for 8 kHz.
    Returns (probs [B], new_state).
    """
    audio, state = _on(params, audio), _on(params, state)
    with torch.inference_mode(), full_f32():
        feats = _conv_features(params, audio, strides)  # [B, T', 64]
        out, (hn, cn) = _lstm(params, feats.transpose(0, 1), state)
        out = F.relu(out).permute(1, 2, 0)  # [B, 64, T']
        logit = F.conv1d(out, params["head_w"], params["head_b"])  # [B, 1, T']
        prob = torch.sigmoid(logit).mean(dim=(1, 2))  # [B]
        return prob, torch.stack([hn, cn])


def silero_scan_frames(
    params: Dict,
    audio,
    state=None,
    frame_samples: int = FRAME_SAMPLES_16K,
) -> torch.Tensor:
    """Per-frame speech probabilities for long audio, batched.

    audio: [B, T] with T a multiple of frame_samples. The conv feature
    stack is frame-local, so all frames run as one batch; the 2-layer LSTM
    carries its state across every frame's steps in one call. Returns
    probs [B, T // frame_samples] on the weights' device.
    """
    audio = _on(params, audio)
    b, t = audio.shape
    f = t // frame_samples
    frames = audio.reshape(b * f, frame_samples)
    state = init_state(b, _device(params)) if state is None else _on(params, state)
    with torch.inference_mode(), full_f32():
        feats = _conv_features(params, frames, (2, 2, 2, 1))  # [B*F, T', 64]
        tprime = feats.shape[1]
        # [B*F, T', 64] -> one sequence over frames and inner steps.
        seq = feats.reshape(b, f * tprime, -1).transpose(0, 1)
        ys, _ = _lstm(params, seq, state)  # [F*T', B, 64]
        out = F.relu(ys).transpose(0, 1)  # [B, F*T', 64]
        logit = out @ params["head_w"][:, :, 0].T + params["head_b"]
        probs = torch.sigmoid(logit)[..., 0]  # [B, F*T']
        # Per-frame prob = mean over the frame's inner time steps.
        return probs.reshape(b, f, tprime).mean(-1)


class SileroVad:
    """Single-stream wrapper: `is_voice(frame)` evaluates one 30 ms frame
    against the threshold, carrying the LSTM state; `reset()` clears it.
    Runs on `device` ("cuda" by default; raises without a card). Batch
    paths use silero_forward / silero_scan_frames directly."""

    def __init__(self, model_path: str = DEFAULT_MODEL_PATH,
                 threshold: float = 0.3, device="cuda"):
        self.device = resolve_device(device)
        self.params = load_silero_params(model_path, device=self.device)
        self.threshold = threshold
        self._state = init_state(1, self.device)

    def prob(self, frame: np.ndarray) -> float:
        frame = _on(self.params, np.asarray(frame, np.float32))[None, :]
        p, self._state = silero_forward(self.params, frame, self._state)
        return float(p[0])

    def is_voice(self, frame: np.ndarray) -> bool:
        return self.prob(frame) > self.threshold

    def reset(self) -> None:
        self._state = init_state(1, self.device)
