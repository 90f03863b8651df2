"""MultiMAE -> timm ViT checkpoint converter, on torch tensors (counterpart
of the JAX package's tools/multimae2vit_converter.py; reference
tools/multimae2vit_converter.py:14-51).

    python -m multimae_tpu_torch.tools.multimae2vit_converter \\
        --multimae_ckpt_path multimae.pth --vit_ckpt_path vit.pth

Key map (multimae_to_vit, one global token):
  global_tokens               -> cls_token
  input_adapters.rgb.pos_emb  -> pos_embed (a zero row prepended for cls)
  input_adapters.rgb.proj.*   -> patch_embed.proj.*
  encoder.*                   -> blocks.*
multimae_to_vitmultimae keeps global_tokens and adds no zero row.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from multimae_tpu_torch.utils.torch_compat import payload_state_dict, torch_load_checkpoint


def _flat_pos_emb(v: torch.Tensor) -> torch.Tensor:
    b, d, h, w = v.shape
    return v.permute(0, 2, 3, 1).reshape(b, h * w, d)


def _convert(sd: Dict[str, torch.Tensor], vit: bool) -> Dict[str, torch.Tensor]:
    state_dict = {}
    for k, v in sd.items():
        if k == "global_tokens":
            state_dict["cls_token" if vit else "global_tokens"] = v
        elif k == "input_adapters.rgb.pos_emb":
            pe = _flat_pos_emb(v)
            if vit:
                pe = torch.cat([pe.new_zeros(pe.shape[0], 1, pe.shape[2]), pe], dim=1)
            state_dict["pos_embed"] = pe
        elif k == "input_adapters.rgb.proj.weight":
            state_dict["patch_embed.proj.weight"] = v
        elif k == "input_adapters.rgb.proj.bias":
            state_dict["patch_embed.proj.bias"] = v
        elif "encoder" in k:
            state_dict[k.replace("encoder", "blocks")] = v
    return state_dict


def multimae_to_vit(multimae_state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return _convert(multimae_state_dict, vit=True)


def multimae_to_vitmultimae(multimae_state_dict: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """timm-style ViTMultiMAE: keeps global_tokens, no zero pos-emb row."""
    return _convert(multimae_state_dict, vit=False)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="MultiMAE to ViT checkpoint converter")
    parser.add_argument("--multimae_ckpt_path", type=str, required=True)
    parser.add_argument("--vit_ckpt_path", type=str, required=True)
    args = parser.parse_args(argv)
    print(f"Loading weights at {args.multimae_ckpt_path}")
    model = payload_state_dict(torch_load_checkpoint(args.multimae_ckpt_path))
    print("Converting from MultiMAE weights to ViT weights...")
    torch.save({"model": multimae_to_vit(model)}, args.vit_ckpt_path)
    print(f"Saved converted weights at {args.vit_ckpt_path}")


if __name__ == "__main__":
    main()
