"""The card's budgets (counterpart of the JAX package's utils/platform.py).

The JAX package asks its backend whether it drives TPU cores and how much
scoped VMEM to request from Mosaic; its engine gates fall back where a
kernel would not fit. The port's kernels are built for the H100 (`sm_90a`)
and their gates and launch plans are decided from shapes alone, the same
on every host, against the constants below: the shared memory one CTA may
opt into, the shared memory of an SM and the part of it the runtime
reserves for each resident CTA. On a CUDA device `card` reads the device's
properties once and raises where the card offers less than the constants
assume, so no gate admits a shape the card cannot launch and none shrinks
without saying so. The same record gives the SM count the launch plans
size their grids by and the device-memory budget of the chained
posteriors' checkpoints.
"""

from __future__ import annotations

import dataclasses

import torch

SMEM_LIMIT = 232448      # shared memory one CTA may opt into (227 KB)
SMEM_SM = 233472         # shared memory of one SM (228 KB)
SMEM_CTA_RESERVED = 1024  # of an SM's, reserved by the runtime per CTA
HBM_FRACTION = 0.5       # of the card's memory, for the checkpoints (gate)


@dataclasses.dataclass(frozen=True)
class Card:
    """What the gates and launch plans read of one CUDA device."""
    name: str
    sm_count: int
    smem_optin: int          # cudaDevAttrMaxSharedMemoryPerBlockOptin
    smem_per_sm: int         # cudaDevAttrMaxSharedMemoryPerMultiprocessor
    total_memory: int


_CARDS: dict[int, Card] = {}


def on_card(device) -> bool:
    """True when `device` is a CUDA device, where the port's kernels run
    (the counterpart of the JAX package's `is_tpu_backend`); its budgets
    are checked against the constants (`card`) on the way."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return False
    card(dev)
    return True


def card(device) -> Card:
    """The budgets of CUDA device `device`, read once per device. Raises
    where the card offers less shared memory than SMEM_LIMIT a CTA or
    SMEM_SM an SM."""
    i = torch.device(device).index or 0
    c = _CARDS.get(i)
    if c is None:
        p = torch.cuda.get_device_properties(i)
        c = Card(name=p.name, sm_count=p.multi_processor_count,
                 smem_optin=p.shared_memory_per_block_optin,
                 smem_per_sm=p.shared_memory_per_multiprocessor,
                 total_memory=p.total_memory)
        if c.smem_optin < SMEM_LIMIT or c.smem_per_sm < SMEM_SM:
            raise RuntimeError(
                f"{c.name} offers {c.smem_optin} bytes of shared memory a "
                f"CTA and {c.smem_per_sm} an SM; the kernels' gates and "
                f"launch plans assume {SMEM_LIMIT} and {SMEM_SM} (sm_90)")
        _CARDS[i] = c
    return c


def sm_count(device) -> int:
    """The card's SM count (cudaDevAttrMultiProcessorCount)."""
    return card(device).sm_count


def device_budget(device=None) -> int:
    """HBM_FRACTION of the card's memory: the rest stays for the caller's
    tensors and the allocator's cache. From the device's properties, so the
    gate is decided from shapes, the same on every call."""
    return int(HBM_FRACTION * card("cuda" if device is None else device)
               .total_memory)
