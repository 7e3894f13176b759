"""Convert a checkpoint of the JAX package (an orbax directory) into a
model checkpoint of the PyTorch port, which the port's ``--ckpt`` and
``--init-params`` read.

  python tools/orbax_to_torch.py JAX_CKPT_DIR OUT_DIR [--epoch N]

The directory is either a train-state checkpoint of the JAX trainer
(``params``, ``batch_stats``, ``opt_state``, ``step``) or a converted
reference checkpoint (``params``, ``batch_stats``), read with
``orbax.checkpoint.PyTreeCheckpointer().restore`` as the JAX package reads
it (multiposenet_tpu/engine/checkpoint.py).  The weights and BatchNorm
statistics cross through the port's ``weights.state_dict_from_flax`` and
are written as ``OUT_DIR/ckpt_<epoch>`` by
``engine/checkpoint.save_model_checkpoint``; the epoch is the one in the
directory's name (``ckpt_<epoch>...``), else 0, unless ``--epoch`` names
one.

Not carried: the optimizer state (Adam's moments) and the step.  A run
resumed from the result starts its optimizer afresh, as a staged stage
does from the previous stage's checkpoint.

This script lives outside both packages: orbax imports JAX, which the port
never imports, and it is no part of the JAX package.  It imports orbax,
numpy and the port, and nothing of ``multiposenet_tpu``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EPOCH_RE = re.compile(r"ckpt_(\d+)")


def read_orbax(path: str) -> dict:
    """The checkpoint's tree as numpy arrays."""
    import numpy as np
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ckptr:
        raw = ckptr.restore(os.path.abspath(path))
    if not isinstance(raw, dict) or "params" not in raw:
        raise ValueError(f"{path}: not a multiposenet_tpu checkpoint (no "
                         "'params' in its tree)")

    def as_numpy(tree):
        if isinstance(tree, dict):
            return {k: as_numpy(v) for k, v in tree.items()}
        return np.asarray(tree)

    return {"params": as_numpy(raw["params"]),
            "batch_stats": as_numpy(raw.get("batch_stats") or {})}


def convert(path: str, out_dir: str, epoch=None) -> str:
    """Write ``path``'s model state as a port checkpoint under ``out_dir``;
    returns its path."""
    from multiposenet_tpu_torch.engine.checkpoint import save_model_checkpoint
    from multiposenet_tpu_torch.utils.logging import logger
    from multiposenet_tpu_torch.weights import state_dict_from_flax

    variables = read_orbax(path)
    if not variables["batch_stats"]:
        logger.warning("%s carries no batch_stats: a port model loading the "
                       "result keeps its BatchNorm statistics", path)
    if epoch is None:
        m = EPOCH_RE.match(os.path.basename(os.path.normpath(path)))
        epoch = int(m.group(1)) if m else 0
    return save_model_checkpoint(out_dir, state_dict_from_flax(variables), epoch)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("jax_ckpt", help="an orbax checkpoint directory")
    ap.add_argument("out_dir", help="the port checkpoint is written as "
                                    "<out_dir>/ckpt_<epoch>")
    ap.add_argument("--epoch", type=int, default=None)
    args = ap.parse_args(argv)
    out = convert(args.jax_ckpt, args.out_dir, args.epoch)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
