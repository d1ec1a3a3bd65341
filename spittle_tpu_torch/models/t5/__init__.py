"""T5 (flan-t5) text cleanup model in PyTorch (port of spittle_tpu/models/t5)."""

from .model import (  # noqa: F401
    FLAN_T5_SMALL,
    T5Config,
    greedy_generate,
    init_kv_cache,
    precompute_cross_kv,
    t5_decode_step,
    t5_decoder_forward,
    t5_encode,
)
from .weights import load_t5_dir, params_from_hf_tensors  # noqa: F401
