"""PyTorch + CUDA port of the HMM spike sorter (Herbst et al. 2008 signal
chain), beside the JAX package `hmmspikesorter_tpu`, which stays the
reference.

Public surface so far (the decode with known templates, any N, with or
without overlaps):
    from hmmspikesorter_torch.models import api   # fit_spiking_model[_fast]
    from hmmspikesorter_torch.io import extraction
    from hmmspikesorter_torch.convert import template_model_from_numpy

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU and no `device="cpu"` they raise. The package imports torch, numpy and
scipy only — never jax, never `hmmspikesorter_tpu`.
"""

__version__ = "0.1.0"
