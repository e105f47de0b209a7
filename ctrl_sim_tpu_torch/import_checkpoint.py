"""Import a reference PyTorch checkpoint into the port's checkpoint layout
(port of ``ctrl_sim_tpu/import_checkpoint.py``).

  python -m ctrl_sim_tpu_torch.import_checkpoint \\
      --torch /path/to/model.ckpt --out checkpoints/imported \\
      --preset ctrl_sim [-o model.hidden_dim=256 ...]

Reads the Lightning checkpoint's ``state_dict``: the reference's
models/ctrl_sim.py layout for the four CtRL-Sim families (``--preset``
ctrl_sim, dt, il or trajeglish), or its models/ctg_plus_plus.py layout
(``diff_model.model.*`` and, with ``model.use_rtg``, ``rtg_model.*``) for
``--preset ctg_plus_plus``. It maps it through ``utils/torch_import.py``
and ``params.from_flax_params`` (held to the executed reference's outputs
by ``tests/test_torch_goldens.py`` and ``tests/test_torch_ctg_goldens.py``),
and writes what the port's trainer saves, ``step_0.pt`` (the weights and a
fresh AdamW state) and ``config.json``, which ``eval_sim`` / ``eval_planner
--ckpt`` and ``train --save_dir`` read. Runs on the CPU; nothing here needs
the card.
"""

from __future__ import annotations

import argparse

from ctrl_sim_tpu_torch.config import _set_dotted, preset
from ctrl_sim_tpu_torch.params import from_flax_params
from ctrl_sim_tpu_torch.train import parse_overrides
from ctrl_sim_tpu_torch.training import trainer_for
from ctrl_sim_tpu_torch.training.checkpoint import CheckpointManager
from ctrl_sim_tpu_torch.utils.torch_import import (
    ctg_params_from_torch_state,
    load_torch_checkpoint,
    params_from_torch_state,
)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--torch", required=True, help="reference .ckpt / .pt path")
    p.add_argument("--out", required=True, help="checkpoint directory of the port")
    p.add_argument("--preset", default="ctrl_sim")
    p.add_argument("-o", "--override", action="append", default=[])
    args = p.parse_args(argv)

    cfg = preset(args.preset)
    for key, value in parse_overrides(args.override).items():
        cfg = _set_dotted(cfg, key, value)

    state_np = load_torch_checkpoint(args.torch)
    to_tree = ctg_params_from_torch_state if cfg.model.ctg_plus_plus else params_from_torch_state
    weights = from_flax_params(to_tree(state_np, cfg))
    trainer = trainer_for(cfg, device="cpu")
    model = trainer.new_model()
    model.load_state_dict(weights, strict=True)
    n = sum(w.numel() for w in weights.values())
    print(f"[import] mapped {len(state_np)} torch tensors -> {n:,} params")

    # a fresh train state around the imported weights (step 0, fresh optimizer)
    CheckpointManager(cfg, args.out).save(0, trainer.state_from_model(model))
    print(f"[import] wrote {args.out} (restore with --ckpt {args.out})")


if __name__ == "__main__":
    main()
