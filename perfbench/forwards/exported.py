"""The forward adapter ``exported``: the port's served entry
``codetr_torch.inferencer.Inferencer`` with, as its forward, the port's
exported program (``codetr_torch.runtime.aot.compile_forward``) at the
cell's canvas, batch and dtype.

``build`` builds the port's model from the configuration file's sizes,
loads the benchmark's float32 state dict with ``load_state_dict(strict=
True)``, casts it with the port's own ``to_compute_dtype``, exports it and
returns the ``Inferencer`` and the ``Tap`` that sits between it and the
program.  Nothing else of the port is used.
"""

from typing import Dict

import torch

from perfbench.system import DTYPES, Tap, port_config


def build(cfg: dict, state_dict: Dict[str, torch.Tensor], canvas, batch: int, device):
    """-> (Inferencer, Tap) serving ``cfg`` at ``canvas`` (height, width) and
    ``batch`` on ``device``."""
    from codetr_torch.inferencer import Inferencer
    from codetr_torch.models.codetr import CoDETR, to_compute_dtype
    from codetr_torch.runtime.aot import compile_forward

    dtype = DTYPES[cfg["dtype"]]
    device = torch.device(device)
    with torch.device(device):
        model = CoDETR(port_config(cfg))
    model.load_state_dict(state_dict, strict=True)
    model = to_compute_dtype(model, dtype).eval()
    height, width = canvas
    program, _ = compile_forward(model, height=height, width=width, batch_size=batch, dtype=dtype)
    tap = Tap(program)
    return Inferencer(model, height=height, width=width, batch_size=batch, compiled_fn=tap,
                      input_dtype=dtype, device=device), tap
