"""PyTorch + CUDA port of the HMM spike sorter (Herbst et al. 2008 signal
chain), beside the JAX package `hmmspikesorter_tpu`, which stays the
reference.

Public surface (README.md lists what is ported):
    from hmmspikesorter_torch.models import api   # decode, training
    from hmmspikesorter_torch.models import multichannel
    from hmmspikesorter_torch.core import posterior, qc
    from hmmspikesorter_torch.parallel import mesh, sharded, sharded_em
    from hmmspikesorter_torch.convert import template_model_from_numpy

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU and no `device="cpu"` they raise. The package imports torch, numpy and
scipy only — never jax, never `hmmspikesorter_tpu`.
"""

__version__ = "0.1.0"
