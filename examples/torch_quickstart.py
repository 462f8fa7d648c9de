"""Quickstart of the PyTorch port: FlexRound against the other rounding
methods on one transformer block (the counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --iters 20

Quantizes the weights of a single small transformer layer to 4 bits with
each registered rounding method, reconstructing the block output from 64
calibration sequences (paper §3, Eq. 2), and prints the reconstruction
errors: the block's error before the Adam loop and the deployed error of
its hard-exported weights after it.
"""
import argparse

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core import (QuantCtx, QuantRecipe, finalize_block,
                              method_api, reconstruct_block)
from repro_torch.device import resolve_device
from repro_torch.models import build_model

CFG = ArchConfig(name="demo", family="dense", n_layers=2, d_model=128,
                 n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
                 dtype="float32", attn_chunk=64, xent_chunk=64, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200,
                    help="Adam steps of each method's reconstruction")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = build_model(CFG)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    calib = torch.randint(0, CFG.vocab, (64, 32),
                          generator=torch.Generator().manual_seed(1)).to(dev)
    x0, blocks, _ = model.quant_blocks(params, calib)
    block = blocks[0]
    y_fp = block.apply(block.params, x0, QuantCtx(mode="fp"))

    print(f"block: {block.name}, sites: {list(block.sites)}")
    print(f"{'method':12s} {'recon before':>14s} {'recon after':>14s}")
    for method in method_api.available_methods():  # every registered method
        recipe = QuantRecipe(method=method, w_bits=4, w_symmetric=True,
                             a_bits=None, iters=args.iters, lr=3e-3,
                             batch_size=16)
        ws, _, rep = reconstruct_block(block, recipe, x0, y_fp, 2)
        deployed = finalize_block(block, recipe, ws, as_qtensor=False)
        y_q = block.apply(deployed, x0, QuantCtx(mode="fp"))
        err = float(torch.mean((y_q - y_fp) ** 2))
        print(f"{method:12s} {rep.err_before:14.3e} {err:14.3e}")
    print("\nExpected: flexround <= adaround < adaquant << rtn "
          "(paper Table 2)")


if __name__ == "__main__":
    main()
