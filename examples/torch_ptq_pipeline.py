"""End-to-end PTQ pipeline of the PyTorch port (the paper's LLM recipe on
the bench LM; the counterpart of ``examples/ptq_pipeline.py``):

  1. pretrain a small LM on the synthetic corpus (cached in
     ``build/bench_cache``),
  2. block-by-block FlexRound reconstruction (per-channel asymmetric
     weights, per-tensor activations, QDrop setting: the LLaMA recipe of
     Table 7), with a per-site SiteRule keeping the first layer at 8-bit
     (pass --no-rules for uniform bits),
  3. export integer weights (QTensor), with per-block fault-tolerant
     checkpoints, and compare perplexity against the fp model and RTN.

    PYTHONPATH=src python examples/torch_ptq_pipeline.py          # card
    PYTHONPATH=src python examples/torch_ptq_pipeline.py --device cpu \\
        --train-steps 20 --iters 4 --calib 16 --eval-batches 2

Any method registered via ``method_api.register_method`` is accepted by
--method; this script has no hard-coded method list.
"""
import argparse
import os
import tempfile

from repro_torch.core import QuantRecipe, method_api, quantize_blocks
from repro_torch.device import resolve_device
from repro_torch.launch import bench_lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="flexround",
                    choices=list(method_api.available_methods()))
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--no-rules", action="store_true",
                    help="uniform precision (skip the W8 first-layer rule)")
    ap.add_argument("--auto-bits", type=float, default=None, metavar="AVG",
                    help="sensitivity-guided automatic mixed precision: "
                         "probe every site and allocate bit-widths to this "
                         "numel-weighted average (replaces the hand-written "
                         "W8 first-layer rule)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "ptq_ckpt"))
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default cuda")
    ap.add_argument("--train-steps", type=int, default=bench_lm.TRAIN_STEPS,
                    help="the bench LM's pretraining steps")
    ap.add_argument("--calib", type=int, default=64,
                    help="calibration sequences")
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--cache-dir", default=bench_lm.CACHE,
                    help="where the pretrained bench LM is cached")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("1) pretraining / loading cached bench LM ...")
    model, params = bench_lm.get_trained_lm(args.train_steps, device=dev,
                                            cache_dir=args.cache_dir)
    fp_ppl = bench_lm.eval_ppl(model, params, args.eval_batches)
    print(f"   fp perplexity: {fp_ppl:.3f}")

    # per-site rule: keep the most quantization-sensitive first layer at W8
    # (glob over site names; later rules would win over earlier ones). With
    # --auto-bits the hand-written rule is replaced by allocator-emitted ones.
    rules = () if (args.no_rules or args.auto_bits) else \
        ("layers.0.*:w_bits=8",)
    print(f"2) block-wise PTQ: {args.method}, W{args.w_bits} per-channel "
          f"asym + A8 per-tensor (QDrop setting), rules={rules}, "
          f"ckpt -> {args.ckpt}")
    recipe = QuantRecipe(method=args.method, setting="qdrop",
                         w_bits=args.w_bits, w_granularity="per_channel",
                         a_bits=8, iters=args.iters, lr=3e-3, batch_size=16,
                         rules=rules)
    x0, blocks, assemble = model.quant_blocks(
        params, bench_lm.calib_tokens(args.calib).to(dev))
    alloc_meta = None
    if args.auto_bits is not None:
        # probe -> solve -> rules: the automatic version of the W8 rule
        from repro_torch.allocate import Budget, auto_allocate
        report = auto_allocate(blocks, recipe, x0,
                               Budget("avg_bits", args.auto_bits))
        print("   " + report.pretty().replace("\n", "\n   "))
        recipe = recipe.with_rules(*report.rules())
        alloc_meta = report.meta()
        report.save(args.ckpt)  # resume validates against this allocation
    finalized, astates, _ = quantize_blocks(
        blocks, recipe, x0, checkpoint_dir=args.ckpt,
        progress=lambda s: print("   " + s), allocation=alloc_meta)
    qparams = assemble(finalized)

    ppl = bench_lm.eval_ppl(model, qparams, args.eval_batches,
                            astates=astates, recipe=recipe)
    print(f"3) quantized perplexity: {ppl:.3f} (fp {fp_ppl:.3f})")

    rtn_recipe = QuantRecipe(method="rtn", setting="qdrop",
                             w_bits=args.w_bits,
                             w_granularity="per_channel", a_bits=8, iters=1,
                             batch_size=16)
    rq, ra, _ = bench_lm.ptq(model, params, rtn_recipe, args.calib)
    rtn_ppl = bench_lm.eval_ppl(model, rq, args.eval_batches, astates=ra,
                                recipe=rtn_recipe)
    print(f"   RTN baseline perplexity: {rtn_ppl:.3f}")
    print("   (expected: flexround << rtn, close to fp — paper Tables 5/7)")
    return {"fp": fp_ppl, "quantized": ppl, "rtn": rtn_ppl, "model": model,
            "qparams": qparams, "astates": astates, "recipe": recipe,
            "rtn_qparams": rq, "rtn_astates": ra, "rtn_recipe": rtn_recipe}


if __name__ == "__main__":
    main()
