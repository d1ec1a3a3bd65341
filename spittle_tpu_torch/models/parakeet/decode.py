"""TDT greedy decoding and CTC decoding in PyTorch (port of
spittle_tpu/models/parakeet/decode.py).

Token-and-Duration Transducer decoding: at each step the joint emits a
token (or blank) and a duration; the time cursor advances by the
duration (by 1 on a zero-duration blank), and the prediction network
consumes only emitted non-blank tokens. The items of a batch step
together with masked updates, as the reference's lax.while_loop does,
here as an eager loop; a max-symbols-per-frame guard forces +1 after too
many same-frame emissions (NeMo semantics).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .config import ParakeetConfig
from .model import joint, pred_init_state, pred_step


def tdt_greedy_decode(
    params: Dict,
    enc: torch.Tensor,  # [B, T, D]
    enc_lens: torch.Tensor,  # [B] valid encoder frames
    cfg: ParakeetConfig,
    max_tokens: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """-> (tokens [B, max_tokens] blank-padded, counts [B], emission frame
    indices [B, max_tokens], steps taken), int64 on enc's device.

    The loop runs while any item's cursor is inside its valid frames and
    fewer than t_max * (max_symbols + 1) steps were taken (every frame
    visit may emit max_symbols zero-duration tokens before the forced
    +1). A token and its frame are written at the item's count only where
    it emits and count < max_tokens; the prediction state moves only where
    it emits."""
    b, t_max, _ = enc.shape
    max_tokens = max_tokens or min(2 * t_max, 600)
    blank = cfg.blank_id
    dev = enc.device
    enc_lens = enc_lens.to(device=dev, dtype=torch.int64)
    rows = torch.arange(b, device=dev)

    pred, (h, c) = _initial_pred(params, b, cfg, enc.dtype, dev)
    t = torch.zeros(b, dtype=torch.int64, device=dev)
    sym = torch.zeros_like(t)
    count = torch.zeros_like(t)
    # One spare column: a write that is masked off lands there.
    tokens = torch.full((b, max_tokens + 1), blank, dtype=torch.int64,
                        device=dev)
    frames = torch.zeros((b, max_tokens + 1), dtype=torch.int64, device=dev)
    step_cap = t_max * (cfg.max_symbols_per_step + 1)
    steps = 0
    while steps < step_cap and bool((t < enc_lens).any()):
        enc_t = enc[rows, t.clamp(0, t_max - 1)]
        logits, dur_logits = joint(params, enc_t, pred)
        k = logits.argmax(dim=-1)
        d = dur_logits.argmax(dim=-1)

        active = t < enc_lens
        emit = active & (k != blank) & (count < max_tokens)
        col = torch.where(emit, count, max_tokens)
        tokens[rows, col] = k
        frames[rows, col] = t
        count = count + emit

        new_pred, (nh, nc) = pred_step(params, k, (h, c), cfg)
        e = emit[:, None]
        pred = torch.where(e, new_pred, pred)
        h = torch.where(e, nh, h)
        c = torch.where(e, nc, c)

        # Advance by the duration head; a zero-duration blank moves 1; the
        # max-symbols guard forces +1 after too many same-frame emissions.
        adv = torch.where((k == blank) & (d == 0), 1, d)
        same_frame = emit & (adv == 0)
        sym = torch.where(same_frame, sym + 1, 0)
        force = same_frame & (sym >= cfg.max_symbols_per_step)
        adv = torch.where(force, 1, adv)
        sym = torch.where(force, 0, sym)
        t = t + torch.where(active, adv, 0)
        steps += 1
    return tokens[:, :max_tokens], count, frames[:, :max_tokens], steps


def _initial_pred(params, batch, cfg, dtype, device):
    """Prediction-network output for the start symbol (blank)."""
    state = pred_init_state(cfg, batch, dtype, device)
    blank_tok = torch.full((batch,), cfg.blank_id, dtype=torch.int64,
                           device=device)
    return pred_step(params, blank_tok, state, cfg)


# ---------------------------------------------------------------------------
# CTC decoding (ParakeetForCTC checkpoints: encoder + Conv1d(d, vocab, 1))
# ---------------------------------------------------------------------------


def ctc_logits(params, enc: torch.Tensor) -> torch.Tensor:
    """Encoder states [B, T, D] -> CTC logits [B, T, vocab+blank], f32."""
    return (enc @ params["ctc_w"] + params["ctc_b"]).float()


def ctc_greedy_decode(params, enc: torch.Tensor, lens: torch.Tensor,
                      blank: int) -> List[List[int]]:
    """Greedy CTC: the per-frame argmax on enc's device, then on the host
    each item's first lens[b] frames with repeats collapsed and blanks
    dropped."""
    ids = ctc_logits(params, enc).argmax(dim=-1).cpu()
    out = []
    for row, n in zip(ids.tolist(), torch.as_tensor(lens).cpu().tolist()):
        seq, prev = [], -1
        for tok in row[:n]:
            if tok != prev and tok != blank:
                seq.append(tok)
            prev = tok
        out.append(seq)
    return out
