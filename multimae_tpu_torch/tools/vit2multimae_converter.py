"""timm ViT -> MultiMAE checkpoint converter, on torch tensors (counterpart
of the JAX package's tools/vit2multimae_converter.py; reference
tools/vit2multimae_converter.py:14-32).

    python -m multimae_tpu_torch.tools.vit2multimae_converter \\
        --vit_ckpt_path vit.pth --multimae_ckpt_path multimae.pth

Key map:
  cls_token + pos_embed[:, 0]  -> global_tokens
  pos_embed[:, 1:] b(hw)d      -> input_adapters.rgb.pos_emb (b d h w)
  patch_embed.proj.*           -> input_adapters.rgb.proj.*
  blocks.*                     -> encoder.*
"""

from __future__ import annotations

import argparse
import math
from typing import Dict

import torch

from multimae_tpu_torch.utils.torch_compat import payload_state_dict, torch_load_checkpoint


def vit_to_multimae(vit_state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    state_dict = {"global_tokens": vit_state_dict["cls_token"].clone()}
    for k, v in vit_state_dict.items():
        if k == "pos_embed":
            n = int(math.sqrt(v.shape[1]))
            grid = v[:, 1:].reshape(v.shape[0], n, n, v.shape[2])
            state_dict["global_tokens"] = state_dict["global_tokens"] + v[:, 0]
            state_dict["input_adapters.rgb.pos_emb"] = grid.permute(0, 3, 1, 2).contiguous()
        elif k == "patch_embed.proj.weight":
            state_dict["input_adapters.rgb.proj.weight"] = v
        elif k == "patch_embed.proj.bias":
            state_dict["input_adapters.rgb.proj.bias"] = v
        elif "blocks." in k:
            state_dict[k.replace("blocks.", "encoder.")] = v
    return state_dict


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ViT to MultiMAE checkpoint converter")
    parser.add_argument("--vit_ckpt_path", type=str, required=True)
    parser.add_argument("--multimae_ckpt_path", type=str, required=True)
    args = parser.parse_args(argv)
    print(f"Loading weights at {args.vit_ckpt_path}")
    model = payload_state_dict(torch_load_checkpoint(args.vit_ckpt_path))
    print("Converting from ViT weights to MultiMAE weights...")
    torch.save({"model": vit_to_multimae(model)}, args.multimae_ckpt_path)
    print(f"Saved converted weights at {args.multimae_ckpt_path}")


if __name__ == "__main__":
    main()
