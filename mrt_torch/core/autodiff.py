"""What the port's gradients need from its modules.

``Replace`` gives a module ``replace(**fields)``, the counterpart of
flax's ``.replace`` on the reference's scene dataclasses: an inverse
render rebuilds its scene from parameters every step
(``mrt_torch.inverse``).  ``refuse_grad`` stops a closest-hit route
whose walk the reference runs in ``lax.while_loop``, which reverse mode
cannot differentiate once the rays or the geometry depend on a
parameter: the route raises instead of returning hits whose t carries
no derivative.
"""

from __future__ import annotations

import copy

import torch


class Replace:
    """Mixin for ``nn.Module``s that hold their arrays as buffers."""

    def replace(self, **fields):
        """A copy of this module with the named buffers, submodules or
        attributes replaced.  The copy shares every other buffer and
        submodule with this one, and keeps a replaced tensor as it is
        given (its autograd graph included); a buffer given as an array
        or a list becomes a tensor of the old buffer's dtype and device.
        Raises TypeError on a name the module does not have."""
        new = copy.copy(self)
        new._buffers = dict(self._buffers)
        new._modules = dict(self._modules)
        new._parameters = dict(self._parameters)
        for name, value in fields.items():
            if name in self._buffers:
                old = self._buffers[name]
                if value is not None and not torch.is_tensor(value):
                    value = (torch.as_tensor(value) if old is None else
                             torch.as_tensor(value, dtype=old.dtype,
                                             device=old.device))
            elif name not in self._modules and (
                    name.startswith("_") or name not in self.__dict__):
                raise TypeError(f"{type(self).__name__}.replace: no field "
                                f"{name!r}")
            setattr(new, name, value)
        return new


def needs_grad(*tensors):
    """True when autograd records and one of `tensors` requires grad."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in tensors)


def refuse_grad(route, o, d, *geometry):
    """Raise ValueError naming `route` when autograd records and the rays
    (o, d) or a buffer of the modules `geometry` require grad."""
    if not torch.is_grad_enabled():
        return
    if needs_grad(o, d) or any(b.requires_grad for m in geometry
                               for b in m.buffers()):
        raise ValueError(
            f"{route}: no gradient through this closest-hit route (the "
            "reference walks it in lax.while_loop, which reverse mode "
            "cannot differentiate); keep its rays and geometry constant "
            "or take the brute-force sphere or triangle routes")
