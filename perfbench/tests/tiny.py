"""A cell small enough for the CPU: the reduced Phi-4-mini of the
program's registry (4 layers, d 128, 4 / 2 heads of 32, vocab 512), short
prompts, 2 decoders of 4 slots."""
from __future__ import annotations

import copy

import architectures
from harness.spec import Cell

E2E = [("output_tokens_per_s", "tokens/s"), ("setup_s", "s")]
OPEN = {"generator": "open_loop",
        "deployment": {"decoders": 2, "slots": 4, "max_len": 160,
                       "decode_impl": "pallas", "num_pages": None},
        "rate_per_s": 8.0, "lead_in_s": 0.5, "system_prompts": 4,
        "system_len": [32, 64], "zipf_s": 1.1, "user_len": [4, 16],
        "output_len": [6, 16]}
CLOSED = {"generator": "closed_loop",
          "deployment": {"decoders": 2, "slots": 4, "max_len": 160,
                         "decode_impl": "paged", "num_pages": None},
          "clients": 12, "ramp_s": 0.5, "requests_per_client": 4, "prompt_len": [16, 64],
          "output_len": [6, 16]}


def dense():
    """The architecture of a configuration that names none."""
    return architectures.load({})


def registry(name: str = "phi4-mini-3.8b"):
    from repro_torch.configs import get_reduced
    return get_reduced(name)


def model_of(reg, act: str = "silu") -> dict:
    return {"num_hidden_layers": reg.num_layers, "hidden_size": reg.d_model,
            "num_attention_heads": reg.num_heads,
            "num_key_value_heads": reg.num_kv_heads,
            "head_dim": reg.resolved_head_dim, "intermediate_size": reg.d_ff,
            "vocab_size": reg.vocab_size, "rope_theta": reg.rope_theta,
            "rms_norm_eps": reg.norm_eps, "hidden_act": act}


def cell(kind: str = "open", limit: float = 0.5, impl=None,
         name: str = "phi4-mini-3.8b") -> Cell:
    reg = registry(name)
    act = "silu" if reg.activation == "swiglu" else "relu2"
    traffic = copy.deepcopy(OPEN if kind == "open" else CLOSED)
    if impl:
        traffic["deployment"]["decode_impl"] = impl
    e2e = [{"name": n, "unit": u} for n, u in E2E]
    return Cell("tiny." + kind, 1, {"name": "tiny", "model": model_of(reg, act)},
                traffic, {"logit_gap": limit, "requests": 4}, e2e, [])
