"""Model-protocol adapters.

Ports ``deepspeed_tpu/models/api.py``. The port's ``initialize()`` takes
any object with ``named_parameters()`` and ``loss(batch, params=...)``;
:class:`FromModule` wraps a foreign ``torch.nn.Module`` into that protocol,
as the JAX package's ``FromFlax`` wraps a flax module (the analogue of the
reference accepting any ``nn.Module``, runtime/engine.py:175). Client
optimizers stay with ROADMAP.md Queue A item 8.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Tuple

import torch
from torch.func import functional_call


class FromModule:
    """Wrap an ``nn.Module`` into the port's model protocol.

    ``loss`` calls ``module(batch, *args, **kwargs)`` with the trainer's
    compute copy of the weights in place of the module's own (through
    ``torch.func.functional_call``; buffers stay the module's), then
    ``loss_fn(out, batch)``. Without ``loss_fn`` the module's output is
    the scalar loss itself."""

    def __init__(self, module: torch.nn.Module,
                 loss_fn: Optional[Callable] = None, args: Tuple = (),
                 kwargs: Optional[dict] = None):
        self.module = module
        self.loss_fn = loss_fn
        self.args = args
        self.kwargs = kwargs or {}

    def named_parameters(self):
        return self.module.named_parameters()

    def loss(self, batch: Any,
             params: Optional[Mapping[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The loss of ``batch`` under ``params`` (default: the module's
        own weights). ``generator`` (the trainer's random stream) is not
        drawn from."""
        if params is None:
            out = self.module(batch, *self.args, **self.kwargs)
        else:
            out = functional_call(self.module, dict(params),
                                  (batch, *self.args), self.kwargs)
        if self.loss_fn is not None:
            return self.loss_fn(out, batch)
        return out


def from_module(module: torch.nn.Module, loss_fn: Optional[Callable] = None,
                **kw) -> FromModule:
    """One-line adapter: ``initialize(model=from_module(net, ce))``."""
    return FromModule(module, loss_fn, **kw)
