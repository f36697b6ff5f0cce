"""HuggingFace weight import and tokenizer glue (counterpart of
ray_tpu/train/adapters.py).

`import_hf_gpt2_weights` and `import_hf_llama_weights` map a
`transformers` model (or its state_dict) onto the port's GPT2 / Llama
state_dict and return it with the matching config. `transformers` is
imported only by `load_tokenizer`; nothing here needs it to import.
`tokenize_dataset` maps a Dataset of text rows to fixed-length token
ids with any tokenizer (a callable or an object with `encode`), and
`hf_dataset_to_ray` turns a `datasets` Dataset (anything with
`column_names` that iterates over row dicts) into a port Dataset.

Layouts: HF GPT-2's Conv1D stores [in, out] and the port's Dense
[out, in], so every GPT-2 projection transposes; HF Llama's nn.Linear is
[out, in] already and maps unchanged. The configs also carry HF's norm
epsilon (`layer_norm_epsilon`, `rms_norm_eps`).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..models.gpt2 import GPT2Config
from ..models.llama import LlamaConfig


def torch_state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    """Detach a torch state_dict to host numpy (fp32)."""
    out = {}
    for k, v in state_dict.items():
        arr = v.detach().cpu().float().numpy() if hasattr(v, "detach") \
            else np.asarray(v)
        out[k] = np.asarray(arr, dtype=np.float32)
    return out


def _source(source):
    """(fp32 CPU tensors by name, HF config or None) of a model or a
    state_dict."""
    if hasattr(source, "state_dict"):
        hf_cfg = getattr(source, "config", None)
        sd = source.state_dict()
    else:
        hf_cfg, sd = None, dict(source)
    return ({k: torch.as_tensor(v).detach().cpu().float()
             for k, v in sd.items()}, hf_cfg)


def import_hf_gpt2_weights(source, cfg: GPT2Config = None
                           ) -> Tuple[Dict[str, torch.Tensor], GPT2Config]:
    """HF GPT2LMHeadModel / GPT2Model, or its state_dict (pass cfg=) ->
    (state_dict of the port's GPT2, cfg). The head is tied to `wte`."""
    sd, hf_cfg = _source(source)
    # GPT2Model ("h.0...") and GPT2LMHeadModel ("transformer.h.0...")
    if any(k.startswith("transformer.") for k in sd):
        sd = {k[len("transformer."):]: v for k, v in sd.items()
              if k.startswith("transformer.")}
    if cfg is None:
        if hf_cfg is None:
            raise ValueError("pass cfg= when importing from a raw state_dict")
        cfg = GPT2Config(vocab_size=hf_cfg.vocab_size,
                         d_model=hf_cfg.n_embd, n_layers=hf_cfg.n_layer,
                         n_heads=hf_cfg.n_head,
                         max_seq_len=hf_cfg.n_positions,
                         norm_eps=hf_cfg.layer_norm_epsilon)

    out = {"wte.weight": sd["wte.weight"], "wpe.weight": sd["wpe.weight"],
           "ln_f_scale": sd["ln_f.weight"], "ln_f_bias": sd["ln_f.bias"]}
    for i in range(cfg.n_layers):
        hf, p = f"h.{i}.", f"h_{i}."
        for n in ("1", "2"):
            out[f"{p}ln_{n}_scale"] = sd[f"{hf}ln_{n}.weight"]
            out[f"{p}ln_{n}_bias"] = sd[f"{hf}ln_{n}.bias"]
        for port, hf_name in (("qkv", "attn.c_attn"),
                              ("attn_out", "attn.c_proj"),
                              ("fc_in", "mlp.c_fc"),
                              ("fc_out", "mlp.c_proj")):
            out[f"{p}{port}.weight"] = sd[f"{hf}{hf_name}.weight"].t() \
                .contiguous()
            out[f"{p}{port}.bias"] = sd[f"{hf}{hf_name}.bias"]
    return out, cfg


def import_hf_llama_weights(source, cfg: LlamaConfig = None
                            ) -> Tuple[Dict[str, torch.Tensor], LlamaConfig]:
    """HF LlamaForCausalLM, or its state_dict (pass cfg=) -> (state_dict
    of the port's Llama, cfg). A checkpoint with no `lm_head.weight`
    ties the head to the embedding."""
    sd, hf_cfg = _source(source)
    if cfg is None:
        if hf_cfg is None:
            raise ValueError("pass cfg= when importing from a raw state_dict")
        cfg = LlamaConfig(
            vocab_size=hf_cfg.vocab_size, d_model=hf_cfg.hidden_size,
            n_layers=hf_cfg.num_hidden_layers,
            n_heads=hf_cfg.num_attention_heads,
            n_kv_heads=hf_cfg.num_key_value_heads,
            d_ff=hf_cfg.intermediate_size,
            max_seq_len=hf_cfg.max_position_embeddings,
            rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
            norm_eps=hf_cfg.rms_norm_eps,
            tie_embeddings="lm_head.weight" not in sd)

    out = {"token_embed.weight": sd["model.embed_tokens.weight"],
           "final_norm": sd["model.norm.weight"]}
    if "lm_head.weight" in sd:
        out["lm_head.weight"] = sd["lm_head.weight"]
    for i in range(cfg.n_layers):
        hf, p = f"model.layers.{i}.", f"layer_{i}."
        out[p + "attn_norm"] = sd[hf + "input_layernorm.weight"]
        out[p + "mlp_norm"] = sd[hf + "post_attention_layernorm.weight"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{p}attention.{n}.weight"] = sd[f"{hf}self_attn.{n}.weight"]
        for n in ("gate_proj", "up_proj", "down_proj"):
            out[f"{p}mlp.{n}.weight"] = sd[f"{hf}mlp.{n}.weight"]
    return out, cfg


def load_tokenizer(name_or_path: str, **kwargs):
    """transformers AutoTokenizer (imported here, on the call; needs
    local files: pass a local path where there is no network)."""
    from transformers import AutoTokenizer  # noqa: PLC0415
    return AutoTokenizer.from_pretrained(name_or_path, **kwargs)


def tokenize_dataset(ds, tokenizer: Callable, *, text_column: str = "text",
                     max_length: int = 512, pad_id: int = 0):
    """Map a ray_tpu_torch.data Dataset of text rows to fixed-length
    token ids.

    tokenizer: HF tokenizer or any callable str -> list[int] (encode).
    Produces columns input_ids [L] int32 and attention_mask [L] int8.
    """
    def encode_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        texts = [str(t) for t in batch[text_column]]
        ids_rows, mask_rows = [], []
        for t in texts:
            if hasattr(tokenizer, "encode"):
                ids = tokenizer.encode(t)
            else:
                ids = tokenizer(t)
            ids = list(ids)[:max_length]
            mask = [1] * len(ids) + [0] * (max_length - len(ids))
            ids = ids + [pad_id] * (max_length - len(ids))
            ids_rows.append(ids)
            mask_rows.append(mask)
        return {"input_ids": np.asarray(ids_rows, np.int32),
                "attention_mask": np.asarray(mask_rows, np.int8)}

    return ds.map_batches(encode_batch)


def hf_dataset_to_ray(hf_dataset, columns: Optional[Iterable[str]] = None):
    """`datasets` Dataset -> ray_tpu_torch.data Dataset (columnar numpy)."""
    from ..data import from_items
    cols = list(columns) if columns else hf_dataset.column_names
    rows = [{c: ex[c] for c in cols} for ex in hf_dataset]
    return from_items(rows)


__all__ = ["torch_state_dict_to_numpy", "import_hf_gpt2_weights",
           "import_hf_llama_weights", "load_tokenizer", "tokenize_dataset",
           "hf_dataset_to_ray"]
