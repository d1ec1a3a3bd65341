"""NeMo `.nemo` checkpoint importer for Parakeet FastConformer-TDT (port of
spittle_tpu/models/parakeet/nemo.py; numpy, torch and the standard
library only).

A `.nemo` file is a tar (gzip or plain) of `model_config.yaml`,
`model_weights.ckpt` (a torch state_dict) and a SentencePiece tokenizer
model. The state_dict maps into the stacked-layer tree:

  encoder.pre_encode.conv.{0,2,3,5,6} / .out  -> subsampling
  encoder.layers.{i}.self_attn.linear_{q,k,v,out,pos} + pos_bias_{u,v}
                                              -> blocks (rel-pos MHA)
  decoder.prediction.embed / dec_rnn.lstm.*_l0 -> prediction network
  joint.enc / joint.pred / joint.joint_net.2   -> TDT joint, with the
      fused output split into [vocab+blank | durations] heads

The reference parses the YAML with PyYAML, which the card machine lacks;
the loader needs only the model's `name` and the duration lists
(`joint.durations`, `model_defaults.tdt_durations`), so `read_block_yaml`
here reads block-style YAML's mappings, scalars and lists of scalars
itself. The SentencePiece pieces are read straight from the .model
protobuf (field 1 = pieces, piece field 1 = string).
"""

from __future__ import annotations

import io
import os
import tarfile
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from spittle_tpu_torch.io.protobuf import iter_fields

from .config import ParakeetConfig

Params = Dict[str, Any]


# -- SentencePiece piece table (protobuf, no dependency) ---------------------

def sentencepiece_pieces(blob: bytes) -> List[str]:
    """Piece strings from a SentencePiece ModelProto.

    ModelProto field 1 (repeated SentencePiece); SentencePiece field 1 is
    the piece string. Order defines token ids."""
    pieces: List[str] = []
    for tag, wire, val in iter_fields(blob, 0, len(blob)):
        if tag == 1 and wire == 2:
            start, end = val
            for t2, w2, v2 in iter_fields(blob, start, end):
                if t2 == 1 and w2 == 2:
                    s, e = v2
                    pieces.append(blob[s:e].decode("utf-8", "replace"))
    return pieces


# -- model_config.yaml (the subset the loader reads) --------------------------

def _strip_comment(line: str) -> str:
    """Drop a '#' comment that starts the line or follows a blank, outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str):
    """A plain or quoted YAML scalar: null, a bool, an int, or a string
    (floats stay strings: the loader reads none)."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        inner = s[1:-1]
        return inner.replace("''", "'") if s[0] == "'" else inner
    low = s.lower()
    if low in ("", "~", "null"):
        return None
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(s)
    except ValueError:
        return s


def _value(text: str):
    s = text.strip()
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    return _scalar(s)


def read_block_yaml(text: str) -> dict:
    """Block-style YAML -> nested dicts whose leaves are scalars and lists
    of scalars (flow lists of scalars included). A list item that is a
    mapping or a list, and a block scalar (| or >), is skipped with
    everything indented under it; other YAML (anchors, tags, flow maps)
    is kept as its text."""
    root: dict = {}
    stack = [(-1, root)]  # (indent of the owning key, mapping)
    open_key = None  # (indent, mapping, key) of a key with no value yet
    skip = None  # lines indented past this belong to a skipped node
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        body = line.strip()
        if not body or body in ("---", "..."):
            continue
        ind = len(line) - len(line.lstrip(" "))
        if skip is not None:
            if ind > skip:
                continue
            skip = None
        if body == "-" or body.startswith("- "):
            item = body[1:].strip()
            if open_key is None or ind < open_key[0]:
                continue
            _, parent, key = open_key
            if parent[key] is None:
                parent[key] = []
            if not isinstance(parent[key], list):
                continue
            if not item or item.startswith(("- ", "{")) or ": " in item \
                    or item.endswith(":"):
                skip = ind  # a nested list or mapping: not read
                continue
            parent[key].append(_value(item))
            continue
        if ":" not in body:
            continue
        if open_key is not None and ind > open_key[0]:
            k_ind, parent, key = open_key
            if parent[key] is None:
                parent[key] = {}
                stack.append((k_ind, parent[key]))
        while stack[-1][0] >= ind:
            stack.pop()
        mapping = stack[-1][1]
        if body.endswith(":"):
            key, rest = body[:-1], ""
        elif ": " in body:
            key, rest = body.split(": ", 1)
        else:
            continue
        key = _scalar(key)
        rest = rest.strip()
        open_key = None
        if rest in ("|", ">") or rest[:1] in ("|", ">") and \
                rest[1:].strip("+-0123456789") == "":
            mapping[key] = None
            skip = ind
        elif rest:
            mapping[key] = _value(rest)
        else:
            mapping[key] = None
            open_key = (ind, mapping, key)
    return root


# -- .nemo tar reading --------------------------------------------------------

def read_nemo_archive(path: str) -> Tuple[dict, Mapping[str, np.ndarray], List[str]]:
    """(model_config as read_block_yaml reads it, state_dict as numpy,
    tokenizer pieces)."""
    mode = "r:gz" if _is_gzip(path) else "r:"
    cfg_data: Optional[bytes] = None
    ckpt_data: Optional[bytes] = None
    spm_data: Optional[bytes] = None
    with tarfile.open(path, mode) as tar:
        for member in tar.getmembers():
            name = os.path.basename(member.name)
            if name == "model_config.yaml":
                cfg_data = tar.extractfile(member).read()
            elif name == "model_weights.ckpt":
                ckpt_data = tar.extractfile(member).read()
            elif name.endswith(".model") and "tokenizer" in member.name:
                spm_data = tar.extractfile(member).read()
    if ckpt_data is None:
        raise FileNotFoundError(f"{path}: no model_weights.ckpt in archive")
    config = read_block_yaml(cfg_data.decode("utf-8")) if cfg_data else {}
    state = torch.load(io.BytesIO(ckpt_data), map_location="cpu",
                       weights_only=True)
    tensors = {k: v.numpy() for k, v in state.items()}
    pieces = sentencepiece_pieces(spm_data) if spm_data else []
    return config, tensors, pieces


def _is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


# -- config + weight mapping --------------------------------------------------

def config_from_nemo(
    config: dict, tensors: Mapping[str, np.ndarray]
) -> ParakeetConfig:
    """Infer a ParakeetConfig from tensor shapes (robust) with the YAML
    filling in what shapes can't tell (duration bins)."""
    t = tensors
    d = int(t["encoder.layers.0.self_attn.linear_q.weight"].shape[0])
    n_heads = int(t["encoder.layers.0.self_attn.pos_bias_u"].shape[0])
    ff = int(t["encoder.layers.0.feed_forward1.linear1.weight"].shape[0])
    ch = int(t["encoder.pre_encode.conv.0.weight"].shape[0])
    lin_in = int(t["encoder.pre_encode.out.weight"].shape[1])
    n_mels = lin_in // ch * 8
    kernel = int(t["encoder.layers.0.conv.depthwise_conv.weight"].shape[-1])
    n_layers = sum(
        1 for k in t
        if k.startswith("encoder.layers.") and k.endswith(".norm_out.weight")
    )
    ph = int(t["decoder.prediction.embed.weight"].shape[1])
    jh = int(t["joint.enc.weight"].shape[0])
    vocab_with_blank = int(t["decoder.prediction.embed.weight"].shape[0])
    joint_out = int(t["joint.joint_net.2.weight"].shape[0])
    durations = joint_out - vocab_with_blank
    if durations <= 0:
        # Plain RNNT joint (no duration head) is out of scope here.
        raise ValueError(
            f"joint output {joint_out} <= vocab+blank {vocab_with_blank}: "
            "not a TDT checkpoint"
        )
    # YAML cross-check when present (model_defaults / joint.tdt durations).
    yaml_durs = _yaml_durations(config)
    if yaml_durs is not None and len(yaml_durs) != durations:
        raise ValueError(
            f"duration-bin mismatch: shapes say {durations}, "
            f"config says {len(yaml_durs)}"
        )
    return ParakeetConfig(
        name=str(config.get("name", "parakeet-tdt")),
        n_mels=n_mels, d_model=d, n_layers=n_layers, n_heads=n_heads,
        ff_mult=max(ff // d, 1), conv_kernel=kernel,
        subsampling_channels=ch, pred_hidden=ph, joint_hidden=jh,
        vocab_size=vocab_with_blank - 1, durations=durations,
    )


def _yaml_durations(config: dict):
    for path in (("joint", "durations"), ("model_defaults", "tdt_durations")):
        node = config
        for key in path:
            if not isinstance(node, dict) or key not in node:
                node = None
                break
            node = node[key]
        if node:
            return list(node)
    return None


def params_from_nemo_tensors(
    tensors: Mapping[str, np.ndarray], cfg: ParakeetConfig
) -> Params:
    """NeMo EncDecRNNTModel (TDT) state_dict -> our full param tree."""
    t = tensors
    n = cfg.n_layers

    def stack(fmt: str, transpose=False, squeeze=None) -> np.ndarray:
        arrs = []
        for i in range(n):
            a = np.asarray(t[fmt.format(i)])
            if squeeze is not None:
                a = np.squeeze(a, axis=squeeze)
            arrs.append(a.T if transpose else a)
        return np.stack(arrs)

    sub = {
        "conv0_w": np.asarray(t["encoder.pre_encode.conv.0.weight"]),
        "conv0_b": np.asarray(t["encoder.pre_encode.conv.0.bias"]),
        "dw1_w": np.asarray(t["encoder.pre_encode.conv.2.weight"]),
        "dw1_b": np.asarray(t["encoder.pre_encode.conv.2.bias"]),
        "pw1_w": np.asarray(t["encoder.pre_encode.conv.3.weight"]),
        "pw1_b": np.asarray(t["encoder.pre_encode.conv.3.bias"]),
        "dw2_w": np.asarray(t["encoder.pre_encode.conv.5.weight"]),
        "dw2_b": np.asarray(t["encoder.pre_encode.conv.5.bias"]),
        "pw2_w": np.asarray(t["encoder.pre_encode.conv.6.weight"]),
        "pw2_b": np.asarray(t["encoder.pre_encode.conv.6.bias"]),
        "proj_w": np.asarray(t["encoder.pre_encode.out.weight"]).T,
        "proj_b": np.asarray(t["encoder.pre_encode.out.bias"]),
    }
    p = "encoder.layers.{}."
    blocks = {
        "ff1_ln_g": stack(p + "norm_feed_forward1.weight"),
        "ff1_ln_b": stack(p + "norm_feed_forward1.bias"),
        "ff1_w1": stack(p + "feed_forward1.linear1.weight", transpose=True),
        "ff1_b1": stack(p + "feed_forward1.linear1.bias"),
        "ff1_w2": stack(p + "feed_forward1.linear2.weight", transpose=True),
        "ff1_b2": stack(p + "feed_forward1.linear2.bias"),
        "attn_ln_g": stack(p + "norm_self_att.weight"),
        "attn_ln_b": stack(p + "norm_self_att.bias"),
        "wq": stack(p + "self_attn.linear_q.weight", transpose=True),
        "bq": stack(p + "self_attn.linear_q.bias"),
        "wk": stack(p + "self_attn.linear_k.weight", transpose=True),
        "bk": stack(p + "self_attn.linear_k.bias"),
        "wv": stack(p + "self_attn.linear_v.weight", transpose=True),
        "bv": stack(p + "self_attn.linear_v.bias"),
        "wo": stack(p + "self_attn.linear_out.weight", transpose=True),
        "bo": stack(p + "self_attn.linear_out.bias"),
        "wpos": stack(p + "self_attn.linear_pos.weight", transpose=True),
        "pos_bias_u": stack(p + "self_attn.pos_bias_u"),
        "pos_bias_v": stack(p + "self_attn.pos_bias_v"),
        "conv_ln_g": stack(p + "norm_conv.weight"),
        "conv_ln_b": stack(p + "norm_conv.bias"),
        "conv_pw1_w": stack(p + "conv.pointwise_conv1.weight",
                            transpose=True, squeeze=-1),
        "conv_pw1_b": stack(p + "conv.pointwise_conv1.bias"),
        "conv_dw_w": stack(p + "conv.depthwise_conv.weight", squeeze=1),
        "conv_dw_b": stack(p + "conv.depthwise_conv.bias"),
        "conv_bn_g": stack(p + "conv.batch_norm.weight"),
        "conv_bn_b": stack(p + "conv.batch_norm.bias"),
        "conv_bn_mean": stack(p + "conv.batch_norm.running_mean"),
        "conv_bn_var": stack(p + "conv.batch_norm.running_var"),
        "conv_pw2_w": stack(p + "conv.pointwise_conv2.weight",
                            transpose=True, squeeze=-1),
        "conv_pw2_b": stack(p + "conv.pointwise_conv2.bias"),
        "ff2_ln_g": stack(p + "norm_feed_forward2.weight"),
        "ff2_ln_b": stack(p + "norm_feed_forward2.bias"),
        "ff2_w1": stack(p + "feed_forward2.linear1.weight", transpose=True),
        "ff2_b1": stack(p + "feed_forward2.linear1.bias"),
        "ff2_w2": stack(p + "feed_forward2.linear2.weight", transpose=True),
        "ff2_b2": stack(p + "feed_forward2.linear2.bias"),
        "final_ln_g": stack(p + "norm_out.weight"),
        "final_ln_b": stack(p + "norm_out.bias"),
    }
    if "decoder.prediction.dec_rnn.lstm.weight_ih_l1" in t:
        raise ValueError(
            "multi-layer prediction LSTM not supported (pred_rnn_layers > 1)"
        )
    # torch LSTM gate order (i, f, g, o) matches pred_step's split; the two
    # torch biases fold into one.
    decoder = {
        "embed": np.asarray(t["decoder.prediction.embed.weight"]),
        "lstm_w": np.asarray(
            t["decoder.prediction.dec_rnn.lstm.weight_ih_l0"]).T,
        "lstm_r": np.asarray(
            t["decoder.prediction.dec_rnn.lstm.weight_hh_l0"]).T,
        "lstm_b": (
            np.asarray(t["decoder.prediction.dec_rnn.lstm.bias_ih_l0"])
            + np.asarray(t["decoder.prediction.dec_rnn.lstm.bias_hh_l0"])
        ),
    }
    vb = cfg.vocab_size + 1
    joint_w = np.asarray(t["joint.joint_net.2.weight"])  # [vb+D, jh]
    joint_b = np.asarray(t["joint.joint_net.2.bias"])
    joint = {
        "enc_w": np.asarray(t["joint.enc.weight"]).T,
        "enc_b": np.asarray(t["joint.enc.bias"]),
        "pred_w": np.asarray(t["joint.pred.weight"]).T,
        "pred_b": np.asarray(t["joint.pred.bias"]),
        "out_w": joint_w[:vb].T,
        "out_b": joint_b[:vb],
        "dur_w": joint_w[vb:].T,
        "dur_b": joint_b[vb:],
    }
    return {
        "subsampling": sub, "blocks": blocks,
        "decoder": decoder, "joint": joint,
    }


def load_nemo(path: str) -> Tuple[ParakeetConfig, Params, List[str]]:
    """.nemo tar -> (config, params, tokenizer pieces)."""
    config, tensors, pieces = read_nemo_archive(path)
    cfg = config_from_nemo(config, tensors)
    params = params_from_nemo_tensors(tensors, cfg)
    return cfg, params, pieces
