"""End-to-end LM training on the PyTorch port, with the gold token's
MRR / NDCG computed inside the step on the device, async checkpoints,
auto-resume, SIGTERM preemption and a straggler monitor.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200    # ~20M
    PYTHONPATH=src python examples/torch_train_lm.py --size 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20

The counterpart of ``train_lm.py``, with its flags; ``--device`` defaults
to ``cuda``.  Run again with the same ``--ckpt-dir`` and it resumes from
the newest committed checkpoint.
"""

import argparse
import os
import tempfile

import torch

from repro_torch.configs.common import smoke_shape
from repro_torch.data import lm_data
from repro_torch.launch.api import get_arch, to_device
from repro_torch.launch.steps import lm_step_bundle
from repro_torch.models.transformer import Transformer, TransformerConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def make_cfg(size: str) -> TransformerConfig:
    if size == "100m":
        # ~100M params: 12L d=768 12H (GPT-2-small-ish, SwiGLU)
        return TransformerConfig(name="lm-100m", n_layers=12, d_model=768,
                                 n_heads=12, n_kv_heads=12, d_ff=2048,
                                 vocab_size=32_000, tie_embeddings=True)
    return TransformerConfig(name="lm-20m", n_layers=6, d_model=384,
                             n_heads=6, n_kv_heads=6, d_ff=1024,
                             vocab_size=8_000, tie_embeddings=True,
                             remat=False)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=("20m", "100m"), default="20m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    cfg = make_cfg(args.size)
    print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    arch = get_arch("olmo-1b")  # reuse the LM step builder
    shape = smoke_shape(arch.shapes["train_4k"], seq_len=args.seq,
                        global_batch=args.batch)
    bundle = lm_step_bundle(cfg, shape, args.device)
    model = Transformer(cfg, device=args.device,
                        generator=torch.Generator(
                            device=args.device).manual_seed(0))
    opt_state = bundle.init_opt(model)

    gen = lm_data.MarkovLM(lm_data.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))

    def step(model, opt_state, batch):
        return bundle.step_fn(model, opt_state, to_device(batch, args.device))

    trainer = Trainer(
        TrainConfig(total_steps=args.steps, log_every=10, ckpt_every=50,
                    ckpt_dir=args.ckpt_dir),
        step, model, opt_state, gen.iterator())
    trainer.install_preemption_handler()
    if trainer.maybe_resume():
        print(f"auto-resumed from step {trainer.step}")
        trainer.data_iter = gen.iterator(start_step=trainer.step)
    trainer.run()
    print(f"done at step {trainer.step}; straggler flags: "
          f"{trainer.monitor.flags}")


if __name__ == "__main__":
    main()
