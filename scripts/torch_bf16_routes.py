"""Step 1 of ``bench_moe``'s MoE LM and of the GPT-2-small LM on the card
through three attention routes, in bf16 and in f32: B1-B3, B1-B3's plain
versions (their rounding points: f32 scores, P rounded to bf16), and the
dense route (scores rounded to bf16, as the JAX reference rounds them).
The MoE steps all route by the first step's top-k picks (teacher-forced),
so only attention differs. Prints each step's loss and gradient norms
against the B1-B3 step of its dtype, and each bf16 loss against the dense
f32 step's.

    python scripts/torch_bf16_routes.py
"""
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    import torch

    from tensorflowonspark_tpu_torch.models import factory
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.train import Trainer, trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log("card:", cs.nvidia_smi_line())
    _build.build_all()
    for name, kw, names in (
            ("moe_transformer", cs.MOE_LM, cs.MOE_GRAD_PARAMS),
            ("transformer", dict(cs.GPT2_SMALL, attention_impl="pallas"),
             cs.GRAD_NORM_PARAMS)):
        batch = cs.lm_batch(8, 1024, kw["vocab_size"])
        picks = None
        res = {}
        for label, dtype, impl, plain in (
                ("flash bf16", torch.bfloat16, "pallas", False),
                ("plain bf16", torch.bfloat16, "pallas", True),
                ("dense bf16", torch.bfloat16, "dense", False),
                ("flash f32", torch.float32, "pallas", False),
                ("plain f32", torch.float32, "pallas", True),
                ("dense f32", torch.float32, "dense", False)):
            model = factory.get_model(name, dtype=dtype, device="cuda",
                                      seed=0, **dict(kw, attention_impl=impl))
            tr = Trainer(model, optimizer=trainer.adamw(3e-4),
                         device="cuda")
            before = dict(fa.launches)
            route = (cs._routing(picks) if name == "moe_transformer"
                     else contextlib.nullcontext())
            with route as r, (cs._plain_flash(fa) if plain
                              else contextlib.nullcontext()):
                state, m = tr.train_step(tr.init(), batch)
            if picks is None and r is not None:
                picks = r.picks
            counts = {n: fa.launches[n] - before[n] for n in fa.launches}
            res[label] = (float(m["loss"]), cs.grad_norms(state, names))
            ref = res["flash bf16"] if "bf16" in label else res.get(
                "flash f32", res[label])
            cs.log("{} {}: loss {:.7f} (rel to flash {:.3e}) launches {} "
                   "norm rel {}".format(
                       name, label, res[label][0],
                       cs._rel(res[label][0], ref[0]), counts,
                       {n: "{:.2e}".format(cs._rel(v, ref[1][n]))
                        for n, v in res[label][1].items()}))
            del model, tr, state
            torch.cuda.empty_cache()
        for label in ("flash bf16", "plain bf16", "dense bf16"):
            cs.log("{} {} against dense f32: loss rel {:.3e}".format(
                name, label, cs._rel(res[label][0], res["dense f32"][0])))


if __name__ == "__main__":
    main()
