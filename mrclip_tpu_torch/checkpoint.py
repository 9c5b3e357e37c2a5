"""Train-state checkpoints of the port (counterpart of the training part of
`mrclip_tpu/checkpoint.py`, whose orbax manager becomes `torch.save`).

A checkpoint is one file, `<ckpt_dir>/step_<N>.pt`: the step, the trainable
parameters by name, the optimizer state (its count and each of its tensors
by parameter name, in their stored types: AdamW's `mu` (bf16 stays bf16)
and `nu`, SGD's `trace`, Lion's `mu`, Adafactor's `v_row`, `v_col` and
`v`) and the state's constants
(the frozen `logit_scale` buffer of a model built with
`logit_scale_trainable=False`), each tensor a CPU copy. It is written to a
temporary file and moved into place with `os.replace`, so a reader sees a
whole checkpoint or none; `keep` keeps the newest `keep` files (the CLI's
`--delete-previous-checkpoint` is `keep=1`). `load_checkpoint` reads it with
`torch.load(weights_only=True)` and, given the live state as `template`,
copies every tensor into the template's own tensors on their device, so the
model's parameters take the saved values bit for bit.

Reading open_clip `.pt` weights is `factory.create_model(pretrained=...)`.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Optional

import torch

__all__ = ["save_checkpoint", "latest_step", "load_checkpoint", "checkpoint_path",
           "saved_steps"]

_NAME = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{int(step)}.pt")


def saved_steps(ckpt_dir: str) -> list:
    """The steps saved in `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m)


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _opt_tensors(opt: Any) -> dict:
    """The optimizer state's fields that hold tensors by name."""
    return {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt) if f.name != "count"}


def save_checkpoint(ckpt_dir: str, step: int, state: Any, *, keep: Optional[int] = None) -> str:
    """Save the train state as step `step`; returns the file written."""
    os.makedirs(ckpt_dir, exist_ok=True)
    opt = state.opt_state
    payload = {
        "step": int(state.step),
        "params": _cpu(state.params),
        "opt_state": {"count": int(opt.count),
                      **{k: _cpu(v) for k, v in _opt_tensors(opt).items()}},
        "constants": _cpu(getattr(state, "constants", None) or {}),
    }
    path = checkpoint_path(ckpt_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if keep is not None:
        for old in saved_steps(ckpt_dir)[:-keep]:
            os.remove(checkpoint_path(ckpt_dir, old))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest saved step in `ckpt_dir`, or None."""
    steps = saved_steps(ckpt_dir)
    return steps[-1] if steps else None


@torch.no_grad()
def _copy_into(dst: dict, src: dict, what: str) -> None:
    if set(dst) != set(src):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise KeyError(f"checkpoint {what} do not match the state: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for k, t in dst.items():
        s = src[k]
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(f"checkpoint {what} {k!r}: {tuple(s.shape)} {s.dtype} saved, "
                             f"{tuple(t.shape)} {t.dtype} in the state")
        t.copy_(s)


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None, template: Any = None) -> Any:
    """Restore step `step` (default: the newest) of `ckpt_dir`, or the file
    `ckpt_dir` itself. With `template` (a `TrainState`), its tensors take the
    saved values in place and the state is returned with the saved step and
    optimizer count; without, the saved dict of CPU tensors."""
    if os.path.isfile(ckpt_dir):
        path = ckpt_dir
    else:
        step = latest_step(ckpt_dir) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        path = checkpoint_path(ckpt_dir, step)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if template is None:
        return payload
    _copy_into(template.params, payload["params"], "parameters")
    opt = template.opt_state
    saved_opt = payload["opt_state"]
    if set(saved_opt) != {"count", *_opt_tensors(opt)}:
        raise KeyError(f"checkpoint optimizer state {sorted(saved_opt)} does not match the "
                       f"state's {type(opt).__name__} ({sorted(_opt_tensors(opt))})")
    for k, v in _opt_tensors(opt).items():
        _copy_into(v, saved_opt[k], f"optimizer state {k!r}")
    _copy_into(getattr(template, "constants", None) or {}, payload.get("constants", {}),
               "constants")
    opt = dataclasses.replace(opt, count=payload["opt_state"]["count"])
    return dataclasses.replace(template, step=payload["step"], opt_state=opt)
