"""Batch spike-sorting CLI of the PyTorch port, `hmmsort-torch` (the
counterpart of the JAX package's `hmmsort`, cli.py).

Contract of the reference CLI (src/hmmsort.jl:36-118), as the JAX CLI
keeps it:

* input HDF5 template file with keys `spikeForms` (K x nchannels x
  ntemplates in the file's Julia/MATLAB layout), `cinv`, `p`; only
  channel 1 of spikeForms is used (hmmsort.jl:56);
* bail to an empty result if `spikeForms` is missing (hmmsort.jl:40-45) or
  more than `max_templates` (default 4) templates are present
  (hmmsort.jl:50-53);
* data HDF5 file read from `rh/data/analogData` else
  `highpassdata/data/data` (hmmsort.jl:66-78); 2-D data uses channel 1;
* decode-only (templates come from an upstream tool), overlaps ON,
  chunked at 100_000 samples (hmmsort.jl:90);
* MAT output dict {mlseq, ll, waveforms, lp, sigma} (hmmsort.jl:94-101),
  where mlseq is the *unrolled* per-neuron state matrix with the
  reference's 1-based ring-position convention (state 1 = silent);
* exit code 23 when input files don't exist (hmmsort.jl:110-113).

Extensions, as in the JAX CLI: `--engine fast` (parallel overlap-save on
the card), `--transfer events` (the fast decodes copy the packed spike
onsets to the host instead of the dense labels and rebuild the labels
exactly there), `--channels all` (every channel of a 2-D recording decoded
independently; with `--engine fast` every channel's windows in one batch),
`--multichannel` (one spike train from all channels
jointly), `--train` (learn the templates from the recording first;
`--save-templates` exports them), `--confidence` and `--qc` (per-spike
posterior confidence and per-unit quality control), `--adaptive` with
`--adapt-chunk` and `--forget` (drift-adaptive: the templates tracked
through the recording by online EM, each chunk decoded and scored under its
own; one channel, `--channels all` or `--multichannel`,
train/adaptive.py).

`--device cuda` (the default) runs on the GPU and raises without one;
`--device cpu` runs the plain PyTorch versions on the CPU in float64.
h5py is imported inside the loaders only: `_sort_loaded` runs everything
after loading from arrays.

Layout note: Julia/MATLAB read HDF5 datasets column-major; h5py reads the
same bytes row-major, so a Julia (K, nchan, N) dataset appears here as
(N, nchan, K) — we transpose back.
"""

from __future__ import annotations

import argparse
import sys
from types import SimpleNamespace

import numpy as np

MAX_TEMPLATES = 4          # reference hmmsort.jl:36
CHUNKSIZE = 100_000        # reference hmmsort.jl:90


def load_template_file(inputfile: str, max_templates: int = MAX_TEMPLATES):
    """Read {spikeForms, cinv, p} -> HMMTemplateModel or None (bail)."""
    import h5py

    from .models.api import HMMTemplateModel

    with h5py.File(inputfile, "r") as ff:
        if "spikeForms" not in ff:
            print("No spike forms found. Bailing...")
            return None
        wf = np.asarray(ff["spikeForms"])
        if wf.ndim == 2:                       # (N, K) single-channel file
            wf = wf[:, None, :]
        wf = wf.T                              # -> (K, nchan, N) Julia layout
        cinv = np.ravel(np.asarray(ff["cinv"]))
        pp = np.ravel(np.asarray(ff["p"]))
        if len(pp) > max_templates:
            print("The number of templates exceeds the maximum. Bailing out...")
            return None
        mu = wf[:, 0, :]                       # channel 1 only (hmmsort.jl:56)
        sigma = float(np.sqrt(1.0 / cinv[0]))
        return HMMTemplateModel(mu=mu, sigma=sigma, lp=np.log(pp),
                                allow_overlaps=True)


def load_template_file_mc(inputfile: str, max_templates: int = MAX_TEMPLATES):
    """Read {spikeForms, cinv, p} keeping EVERY template channel
    (beyond-reference: the reference drops all but channel 1,
    hmmsort.jl:56) -> HMMTemplateModelMC or None (bail).

    Per-channel noise comes from cinv: a (C,) vector is per-channel inverse
    variances; a (C, C) matrix contributes its diagonal; a scalar
    broadcasts (sigma_c = sqrt(1 / cinv_c), the C-channel reading of
    hmmsort.jl:56)."""
    import h5py

    from .models.multichannel import HMMTemplateModelMC

    with h5py.File(inputfile, "r") as ff:
        if "spikeForms" not in ff:
            print("No spike forms found. Bailing...")
            return None
        wf = np.asarray(ff["spikeForms"])
        if wf.ndim == 2:                       # (N, K) single-channel file
            wf = wf[:, None, :]
        wf = wf.T                              # -> (K, nchan, N) Julia layout
        cinv = np.asarray(ff["cinv"])
        pp = np.ravel(np.asarray(ff["p"]))
        if len(pp) > max_templates:
            print("The number of templates exceeds the maximum. Bailing out...")
            return None
        K, C, N = wf.shape
        mu = wf.transpose(0, 2, 1)             # (K, N, C)
        if cinv.ndim == 2 and cinv.shape == (C, C):
            cdiag = np.diag(cinv)
        elif np.ravel(cinv).size in (1, C):
            cdiag = np.broadcast_to(np.ravel(cinv), (C,))
        else:
            raise ValueError(
                f"cinv has {np.ravel(cinv).size} entries for {C} template "
                f"channels; expected a scalar, a ({C},) vector, or a "
                f"({C}, {C}) matrix")
        sigmas = np.sqrt(1.0 / np.asarray(cdiag, np.float64))
        return HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=np.log(pp),
                                  allow_overlaps=True)


def save_template_file(path: str, mu, sigma, lp) -> None:
    """Write learned templates as a {spikeForms, cinv, p} HDF5 file
    round-trippable through load_template_file / load_template_file_mc
    (and readable by Julia/MATLAB consumers of the reference's template
    format, src/hmmsort.jl:39-57).

    mu: (K, N) single-channel or (K, N, C) multi-channel templates;
    sigma: scalar or (C,) noise std; lp: (N,) onset log-probs.
    Julia reads a (K, C, N) column-major dataset; writing the h5py
    row-major transpose (N, C, K) produces exactly those bytes."""
    import h5py

    mu = np.asarray(mu, np.float64)
    wf = mu[:, None, :] if mu.ndim == 2 else mu.transpose(0, 2, 1)
    sig = np.ravel(np.asarray(sigma, np.float64))
    with h5py.File(path, "w") as ff:
        ff["spikeForms"] = np.ascontiguousarray(wf.T)   # (N, C, K)
        ff["cinv"] = 1.0 / (sig * sig)
        ff["p"] = np.exp(np.asarray(lp, np.float64))


def load_data_file(datafile: str, *, channels=1,
                   keep_int: bool = False) -> np.ndarray:
    """Read the voltage trace (reference hmmsort.jl:66-88).

    channels=1 (reference behavior) returns channel 1 as a (T,) trace;
    channels="all" returns every channel as a (C, T) matrix (a 1-D
    dataset becomes (1, T)).

    keep_int=True preserves an integer on-disk dtype (int16 ADC data is
    the common format) instead of the reference's Float64 conversion
    (hmmsort.jl:80-88): the fast decode ships integers to the device raw
    and casts them there — float(int16) is exact, so results are identical
    while the host->device transfer halves."""
    import h5py

    with h5py.File(datafile, "r") as ff:
        if "rh" in ff:
            ds = ff["rh/data/analogData"]
        else:
            ds = ff["highpassdata/data/data"]
        data = np.asarray(ds)
    if data.ndim == 2:
        # The reference reads a Julia/MATLAB (T, ncols) column-major matrix
        # and takes column 1 (hmmsort.jl:66-78). The same bytes appear
        # through h5py with the dims reversed, (ncols, T), so column 1 ==
        # row 0 — unconditionally: a long-axis guess would silently pick
        # the wrong orientation on a recording with more channels than
        # samples. With channels="all" the h5py rows are exactly the
        # Julia columns, already (C, T).
        if channels != "all":
            data = data[0]
    elif channels == "all":
        data = data[None]
    if keep_int and np.issubdtype(data.dtype, np.integer):
        return np.ascontiguousarray(data)
    return np.asarray(data, dtype=np.float64)


def _conf_and_qc(model, confidence: bool, qc: bool, *, device=None,
                 dtype=None):
    """(--confidence MAT cell or None, --qc MAT struct or None) for one
    decoded model. The (T, N) onset-posterior grid — the expensive part
    — is computed ONCE on `device` and shared by both outputs (per-spike
    confidence AND QC's missing-spike-mass). Exact at any length: long
    recordings route to the chained parallel two-pass (core/posterior)."""
    if not (confidence or qc):
        return None, None
    from .core.events import _onsets_dense
    from .core.posterior import (confidence_from_posteriors,
                                 model_posteriors)
    from .core.qc import qc_arrays, unit_qc

    tm = model.template_model
    p = model_posteriors(model, device=device, dtype=dtype)
    cell = None
    if confidence:
        onsets = getattr(model, "spike_onsets", None)
        if onsets is None:
            onsets = _onsets_dense(np.asarray(model.ml_seq),
                                   N=tm.n_neurons, K=tm.K,
                                   overlaps=tm.allow_overlaps)
        confs = confidence_from_posteriors(p, onsets,
                                           half_width=(tm.K - 1) // 2)
        cell = np.empty(len(confs), dtype=object)
        for n, c in enumerate(confs):
            cell[n] = np.asarray(c, np.float64)
    qcs = None
    if qc:
        conf = list(cell) if cell is not None else None
        qcs = qc_arrays(unit_qc(model, confidence=conf, posteriors=p))
    return cell, qcs


def _conf_and_qc_cells(models, confidence: bool, qc: bool, *, device=None,
                       dtype=None):
    """Per-channel cells of _conf_and_qc outputs."""
    if not (confidence or qc):
        return None, None
    conf_cells = np.empty(len(models), dtype=object)
    qc_cells = np.empty(len(models), dtype=object)
    for i, mod in enumerate(models):
        conf_cells[i], qc_cells[i] = _conf_and_qc(mod, confidence, qc,
                                                  device=device, dtype=dtype)
    return (conf_cells if confidence else None,
            qc_cells if qc else None)


def _emit_output(output: dict, outputfile: str, dosave: bool) -> dict:
    """Shared result epilogue: optionally write the MAT file, return the
    reference output dict ({mlseq, ll, waveforms, lp, sigma},
    hmmsort.jl:94-101 contract) — one place for every sort_data branch."""
    if dosave:
        import scipy.io

        scipy.io.savemat(outputfile, output)
        print(f"Done! Results saved to {outputfile}")
    return output


def _options(config=None, *, engine=None, chunksize=None, max_templates=None,
             channels=None, multichannel=None, confidence=None, qc=None,
             adaptive=None, adapt_chunk=None, forget=None, transfer=None,
             train: bool = False):
    """The decode options of one sort: explicit kwarg > config.decode >
    the reference default, with the combinations the port refuses."""
    from .config import UNSET, _section, pick

    dc = _section(config, "decode")

    def arg(v, field, default):
        return pick(UNSET if v is None else v, dc(field), default)

    o = SimpleNamespace(
        engine=arg(engine, "engine", "reference"),
        chunksize=arg(chunksize, "chunksize", CHUNKSIZE),
        max_templates=arg(max_templates, "max_templates", MAX_TEMPLATES),
        channels=arg(channels, "channels", 1),
        multichannel=bool(arg(multichannel, "multichannel", False)),
        confidence=bool(arg(confidence, "confidence", False)),
        qc=bool(arg(qc, "qc", False)),
        adaptive=bool(arg(adaptive, "adaptive", False)),
        adapt_chunk=arg(adapt_chunk, "adapt_chunk", 32768),
        forget=arg(forget, "forget", 0.3),
        transfer=arg(transfer, "transfer", "dense"))
    if o.multichannel and o.channels == "all":
        raise ValueError("multichannel (joint decode) and channels='all' "
                         "(independent per-channel decode) are mutually "
                         "exclusive")
    return o


def sort_data(inputfile: str | None, datafile: str, outputfile: str, *,
              dosave: bool = True, max_templates: int | None = None,
              chunksize: int | None = None, progress=None,
              engine: str | None = None, channels=None,
              multichannel: bool | None = None, config=None,
              train: bool = False, n_templates: int | None = None,
              K: int | None = None, nsteps: int | None = None,
              train_samples: int | None = None,
              save_templates: str | None = None, rng=None,
              confidence: bool | None = None,
              adaptive: bool | None = None,
              adapt_chunk: int | None = None,
              forget: float | None = None,
              qc: bool | None = None, device=None, dtype=None) -> dict:
    """End-to-end batch sort (reference sort_data, hmmsort.jl:36-104) on
    `device` (None: the GPU; "cpu": the plain versions, float64 by
    default): load the HDF5 inputs, then `_sort_loaded`.

    engine="reference": the reference's sequential chunked decode (exact
    protocol parity, including the cumulative ll in the output).
    engine="fast": the parallel overlap-save decode, with automatic seam
    repair and the same finite cumulative-score ll.

    channels=1 (default) decodes channel 1 only — the reference contract
    (hmmsort.jl:66-78). channels="all" decodes every channel of a 2-D
    recording against the shared templates: one after another with engine
    "reference", every channel's windows in one batch with engine "fast"
    (models/api.fit_spiking_models_fast_batched). The output keeps the
    same keys with a leading channel axis: mlseq (C, N, T) and ll (C,).

    multichannel=True (beyond reference) decodes ONE spike train from ALL
    channels jointly (models/multichannel): waveforms is (K, N, C) and
    sigma a (C,) vector. Mutually exclusive with channels="all".

    train=True (beyond the reference CLI) learns the templates from the
    recording itself via the reference training protocol before decoding:
    no inputfile -> from scratch (`n_templates` random inits, `nsteps` EM
    steps); inputfile given -> warm start (reference fit!, fit.jl:49-52);
    `train_samples` > 0 trains on that prefix; `save_templates` writes the
    learned {spikeForms, cinv, p} HDF5. Works with multichannel=True and
    channels="all" (per-channel models; output entries become
    per-channel cells, each channel decoded by either engine).

    confidence / qc add per-spike posterior confidence and per-unit QC.

    adaptive=True (beyond reference) replaces the stationary decode with
    the drift-adaptive one (models/api.fit_spiking_model_adaptive):
    online-EM template tracking with forgetting `forget` over
    `adapt_chunk`-sample chunks, each chunk decoded with its own adapted
    templates; composes with train (track from the learned templates),
    confidence (each spike scored under its chunk's parameters) and
    channels="all" (independent per-channel tracks,
    train/adaptive.track_drift_batched) and multichannel=True (one joint
    track, models/multichannel.fit_spiking_model_adaptive_mc). The config's
    decode.transfer
    ("events": the sparse onset transfer) reaches every fast decode. A
    config.Config supplies defaults for anything not passed explicitly.
    """
    from .utils.device import resolve_device

    device = resolve_device(device)
    o = _options(config, engine=engine, chunksize=chunksize,
                 max_templates=max_templates, channels=channels,
                 multichannel=multichannel, confidence=confidence, qc=qc,
                 adaptive=adaptive, adapt_chunk=adapt_chunk, forget=forget,
                 train=train)
    load_t = load_template_file_mc if o.multichannel else load_template_file
    tm = None
    if inputfile is not None or not train:
        print("Loading templates...")
        tm = load_t(inputfile, o.max_templates)
        if tm is None:
            return {}
        if not train:
            print("Creating template model...")
    print("Loading data...")
    if o.multichannel:
        data = load_data_file(datafile, channels="all")          # (C, T)
    else:
        # the fast engine casts integer recordings on the device (exact) —
        # keep int16 data raw so the upload is half the bytes
        data = load_data_file(datafile, channels=o.channels,
                              keep_int=(o.engine == "fast" and not train
                                        and o.channels != "all"))
    return _sort_loaded(tm, data, outputfile, o, dosave=dosave,
                        progress=progress, config=config, train=train,
                        n_templates=n_templates, K=K, nsteps=nsteps,
                        train_samples=train_samples,
                        save_templates=save_templates, rng=rng,
                        device=device, dtype=dtype)


def _sort_loaded(tm, data, outputfile: str, o, *, dosave: bool = True,
                 progress=None, config=None, train: bool = False,
                 n_templates=None, K=None, nsteps=None, train_samples=None,
                 save_templates=None, rng=None, device=None,
                 dtype=None) -> dict:
    """Everything of sort_data after loading, from arrays: `tm` the loaded
    template model (None to train from scratch), `data` the recording as
    load_data_file returns it ((C, T) for multichannel), `o` the options
    of `_options`. Guards, trains, decodes, scores and writes the MAT
    dict."""
    from .io.extraction import unroll_mlseq
    from .models.api import fit_spiking_model, fit_spiking_model_fast
    from .utils.device import resolve_device
    from .utils.guards import guard_inputs

    kw = dict(device=resolve_device(device), dtype=dtype)
    if o.multichannel:
        return _sort_loaded_mc(tm, data, outputfile, o, dosave=dosave,
                               progress=progress, config=config, train=train,
                               n_templates=n_templates, K=K, nsteps=nsteps,
                               train_samples=train_samples,
                               save_templates=save_templates, rng=rng, kw=kw)
    channels, engine = o.channels, o.engine
    if train:
        from .models.api import fit_template_model, refit_template_model

        rows = data if channels == "all" else data[None]
        guard_inputs(data, 1.0)        # NaN scan before training
        tms = []
        for c, row in enumerate(rows):
            y_tr = row[:train_samples] if train_samples else row
            where = f" [channel {c}]" if channels == "all" else ""
            if tm is not None:
                print(f"Refitting templates (warm start){where}...")
                m = refit_template_model(
                    tm, y_tr, nsteps if nsteps is not None else 10, **kw)
            else:
                print(f"Training templates{where}...")
                m = fit_template_model(y_tr, n_templates, K, nsteps,
                                       rng=rng, config=config, **kw)
            m.allow_overlaps = True     # CLI decode convention
            if m.n_neurons > o.max_templates:
                print("The number of templates exceeds the maximum. "
                      "Bailing out...")
                return {}
            tms.append(m)
        if save_templates:
            if channels == "all":
                import os.path

                root, ext = os.path.splitext(save_templates)
                for c, m in enumerate(tms):
                    save_template_file(f"{root}_ch{c:02d}{ext}",
                                       m.mu, m.sigma, m.lp)
                print(f"Per-channel templates saved next to "
                      f"{save_templates}")
            else:
                save_template_file(save_templates, tms[0].mu,
                                   tms[0].sigma, tms[0].lp)
                print(f"Templates saved to {save_templates}")
        if channels == "all":
            # per-channel models can keep different template counts, so
            # the output entries are per-channel cells (object arrays)
            models = [
                (fit_spiking_model_fast(m, row, streaming=True,
                                        transfer=o.transfer, config=config,
                                        **kw)
                 if engine == "fast" else
                 fit_spiking_model(m, row, chunksize=o.chunksize,
                                   progress=progress, **kw))
                for m, row in zip(tms, rows)]
            cell = np.empty(len(models), dtype=object)
            wf_cell = np.empty(len(tms), dtype=object)
            lp_cell = np.empty(len(tms), dtype=object)
            for c, (m, mod) in enumerate(zip(tms, models)):
                cell[c] = unroll_mlseq(mod.ml_seq, m.state_space.states) + 1
                wf_cell[c] = m.mu
                lp_cell[c] = m.lp
            output = {
                "mlseq": cell,
                "ll": np.array([mod.ll for mod in models]),
                "waveforms": wf_cell,
                "lp": lp_cell,
                "sigma": np.array([m.sigma for m in tms]),
            }
            conf_cells, qc_cells = _conf_and_qc_cells(models, o.confidence,
                                                      o.qc, **kw)
            if o.confidence:
                output["confidence"] = conf_cells
            if o.qc:
                output["qc"] = qc_cells
            return _emit_output(output, outputfile, dosave)
        tm = tms[0]
        data = rows[0]
    else:
        guard_inputs(data, tm.sigma)   # fail fast on NaN data / bad sigma
        #                                (integer data skips the NaN scan)
    print("Fitting model...")
    if channels == "all":
        if o.adaptive:
            # independent per-channel drift tracks, each channel decoded
            # under its own adapted templates
            from .train.adaptive import decode_tracked, track_drift_batched

            rows64 = np.asarray(data, np.float64)
            tracks = track_drift_batched(tm, rows64, chunk=o.adapt_chunk,
                                         forget=o.forget, **kw)
            models = [decode_tracked(trk, rows64[c], transfer=o.transfer,
                                     **kw) for c, trk in enumerate(tracks)]
        elif engine == "fast":
            from .models.api import fit_spiking_models_fast_batched

            models = fit_spiking_models_fast_batched(
                tm, data, transfer=o.transfer, config=config, **kw)
        else:
            models = [fit_spiking_model(tm, row, chunksize=o.chunksize,
                                        progress=progress, **kw)
                      for row in data]
        mlseq = np.stack([unroll_mlseq(m.ml_seq, tm.state_space.states) + 1
                          for m in models])
        ll = np.array([m.ll for m in models])
    else:
        if o.adaptive:
            # drift-adaptive: online-EM template tracking, then every chunk
            # decoded with its own adapted templates (overrides --engine)
            from .models.api import fit_spiking_model_adaptive

            model = fit_spiking_model_adaptive(
                tm, np.asarray(data, np.float64), chunk=o.adapt_chunk,
                forget=o.forget, transfer=o.transfer, **kw)
        elif engine == "fast":
            model = fit_spiking_model_fast(tm, data, streaming=True,
                                           transfer=o.transfer,
                                           config=config, **kw)
        else:
            model = fit_spiking_model(tm, data, chunksize=o.chunksize,
                                      progress=progress, **kw)
        # reference output convention: unrolled per-neuron ring positions,
        # 1-based with 1 == silent (StateMatrix stores positions + 1,
        # types.jl:150)
        mlseq = unroll_mlseq(model.ml_seq, tm.state_space.states) + 1
        ll = model.ll
    output = {
        "mlseq": mlseq,
        "ll": ll,
        "waveforms": tm.mu,
        "lp": tm.lp,
        "sigma": tm.sigma,
    }
    if channels == "all":
        conf_cells, qc_cells = _conf_and_qc_cells(models, o.confidence, o.qc,
                                                  **kw)
    else:
        conf_cells, qc_cells = _conf_and_qc(model, o.confidence, o.qc, **kw)
    if o.confidence:
        output["confidence"] = conf_cells
    if o.qc:
        output["qc"] = qc_cells
    return _emit_output(output, outputfile, dosave)


def _sort_loaded_mc(tmc, data, outputfile, o, *, dosave, progress, config,
                    train, n_templates, K, nsteps, train_samples,
                    save_templates, rng, kw) -> dict:
    """The multichannel branch of _sort_loaded: data is (C, T)."""
    from .config import UNSET, _section, pick
    from .io.extraction import unroll_mlseq
    from .models.multichannel import (fit_spiking_model_mc,
                                      fit_spiking_model_mc_fast,
                                      refit_template_model_mc)
    from .utils.guards import guard_inputs

    dc = _section(config, "decode")
    if train:
        guard_inputs(data, 1.0)    # fail fast on NaN before the EM run
        if tmc is not None:
            # same channel contract as the decode-only path: the recording
            # must cover the template channels; extra channels are dropped
            # before training AND decode
            if data.shape[0] < tmc.n_channels:
                raise ValueError(
                    f"recording has {data.shape[0]} channels but the "
                    f"templates have {tmc.n_channels}")
            data = data[: tmc.n_channels]
        yc_full = np.ascontiguousarray(data.T)            # (T, C)
        y_tr = yc_full[:train_samples] if train_samples else yc_full
        if tmc is not None:
            print("Refitting templates (warm start)...")
            tmc = refit_template_model_mc(
                tmc, y_tr, nsteps if nsteps is not None else 10, **kw)
        else:
            from .train.em_mc import train_model_mc

            print("Training templates...")
            tmc, _, _ = train_model_mc(
                y_tr, n_templates if n_templates is not None else 3,
                K if K is not None else
                (60 if config is None else config.model.K),
                nsteps if nsteps is not None else 10, rng=rng, **kw)
        tmc.allow_overlaps = True           # CLI decode convention
        if tmc.n_neurons > o.max_templates:
            print("The number of templates exceeds the maximum. "
                  "Bailing out...")
            return {}
        if save_templates:
            save_template_file(save_templates, tmc.mu, tmc.sigmas, tmc.lp)
            print(f"Templates saved to {save_templates}")
        yc = yc_full
    else:
        if data.shape[0] < tmc.n_channels:
            raise ValueError(
                f"recording has {data.shape[0]} channels but the "
                f"templates have {tmc.n_channels}")
        yc = np.ascontiguousarray(data[: tmc.n_channels].T)  # (T, C)
    guard_inputs(yc.T, tmc.sigmas)
    print("Fitting model...")
    if o.adaptive:
        from .models.multichannel import fit_spiking_model_adaptive_mc

        model = fit_spiking_model_adaptive_mc(
            tmc, np.asarray(yc, np.float64), chunk=o.adapt_chunk,
            forget=o.forget, transfer=o.transfer, **kw)
    elif o.engine == "fast":
        model = fit_spiking_model_mc_fast(
            tmc, yc,
            L=pick(UNSET, dc("L"), 8192),
            H=pick(UNSET, dc("H"), None),
            streaming=pick(UNSET, dc("streaming"), None),
            blocks_per_call=pick(UNSET, dc("blocks_per_call"), 256),
            prefetch=pick(UNSET, dc("prefetch"), 2),
            repair=pick(UNSET, dc("repair"), True),
            transfer=o.transfer, **kw)
    else:
        model = fit_spiking_model_mc(tmc, yc, chunksize=o.chunksize,
                                     progress=progress, **kw)
    output = {
        "mlseq": unroll_mlseq(model.ml_seq, tmc.state_space.states) + 1,
        "ll": model.ll,
        "waveforms": tmc.mu,
        "lp": tmc.lp,
        "sigma": tmc.sigmas,
    }
    conf_cell, qc_struct = _conf_and_qc(model, o.confidence, o.qc, **kw)
    if o.confidence:
        output["confidence"] = conf_cell
    if o.qc:
        output["qc"] = qc_struct
    return _emit_output(output, outputfile, dosave)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="hmmsort-torch",
        description="HMM spike sorting (PyTorch/CUDA): decode a recording "
                    "with known templates, or learn them first "
                    "with --train")
    p.add_argument("--inputfile",
                   help="File containing templates to be used for sorting "
                        "(required unless --train; with --train it warm-"
                        "starts the refit instead)")
    p.add_argument("--datafile", required=True,
                   help="Data file containing data to be sorted")
    p.add_argument("--outputfile", required=True,
                   help="File to save the spiking model to")
    p.add_argument("--chunksize", type=int, default=CHUNKSIZE)
    p.add_argument("--engine", choices=["reference", "fast"],
                   default="reference",
                   help="'reference' = sequential chunked decode (exact "
                        "reference protocol); 'fast' = parallel "
                        "overlap-save (the GPU production path)")
    p.add_argument("--channels", choices=["1", "all"], default="1",
                   help="'1' = channel 1 only (reference contract); "
                        "'all' = decode every channel of a 2-D recording "
                        "(output mlseq/ll gain a leading channel axis; "
                        "with --engine fast every channel's windows "
                        "decode in one batch)")
    p.add_argument("--transfer", choices=["dense", "events"],
                   default="dense",
                   help="'events' = the fast decodes copy the packed spike "
                        "onsets to the host instead of the dense labels "
                        "and rebuild the labels exactly there")
    p.add_argument("--multichannel", action="store_true",
                   help="decode ONE spike train from ALL channels jointly, "
                        "using every channel of spikeForms (the reference "
                        "uses channel 1 only); mutually exclusive with "
                        "--channels all")
    p.add_argument("--train", action="store_true",
                   help="learn the templates from the recording itself "
                        "(reference training protocol: EM -> merge/prune "
                        "-> EM/2) before decoding — no upstream template "
                        "tool needed; with --inputfile, warm-starts from "
                        "its templates instead")
    p.add_argument("--ntemplates", type=int, default=None,
                   help="initial template count for --train from scratch "
                        "(default 3, the reference train_model default; "
                        "merge/prune decides the final count)")
    p.add_argument("--K", type=int, default=None,
                   help="template length in samples for --train from "
                        "scratch (default 60, the reference train_model "
                        "default; ignored with an --inputfile warm start)")
    p.add_argument("--nsteps", type=int, default=None,
                   help="EM iterations for --train (default 10)")
    p.add_argument("--train-samples", type=int, default=None,
                   help="train on only the first this-many samples "
                        "(default: the whole recording); the decode always "
                        "covers the full recording")
    p.add_argument("--confidence", action="store_true",
                   help="add per-spike posterior confidence scores to the "
                        "MAT output (key 'confidence': one array per "
                        "neuron, aligned with its decoded spikes; "
                        "forward-backward onset mass, core/posterior)")
    p.add_argument("--save-templates", default=None,
                   help="also write the learned templates as a "
                        "{spikeForms, cinv, p} HDF5 file reusable as "
                        "--inputfile of a plain decode run")
    p.add_argument("--qc", action="store_true",
                   help="add a per-unit quality-control struct to the "
                        "MAT output (key 'qc': spike counts/rates, ISI "
                        "violations, SNR, presence ratio, confidence "
                        "summary, drift metrics when --adaptive; "
                        "core/qc.py)")
    p.add_argument("--adaptive", action="store_true",
                   help="drift-adaptive decode: track the templates "
                        "through the recording with online EM and decode "
                        "every chunk with its own adapted templates "
                        "(electrode-drift robustness; one channel, "
                        "--channels all or --multichannel; overrides "
                        "--engine; composes with --train and --confidence)")
    p.add_argument("--adapt-chunk", type=int, default=None,
                   help="adaptive tracking chunk = decode window in "
                        "samples (default 32768)")
    p.add_argument("--forget", type=float, default=None,
                   help="adaptive forgetting factor in (0, 1]: memory "
                        "horizon ~ chunk/forget samples (default 0.3)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cuda' = the GPU's kernels (raises without a "
                        "GPU); 'cpu' = the plain PyTorch versions, "
                        "float64")
    args = p.parse_args(argv)

    import os

    if args.inputfile is None and not args.train:
        print("Both inputfile and data file must exist")
        return 23                               # reference hmmsort.jl:113
    if not ((args.inputfile is None or os.path.isfile(args.inputfile))
            and os.path.isfile(args.datafile)):
        print("Both inputfile and data file must exist")
        return 23                               # reference hmmsort.jl:113
    from .config import Config, DecodeConfig

    cfg = Config(decode=DecodeConfig(engine=args.engine,
                                     chunksize=args.chunksize,
                                     channels=(1 if args.channels == "1"
                                               else "all"),
                                     multichannel=args.multichannel,
                                     transfer=args.transfer,
                                     confidence=args.confidence,
                                     qc=args.qc,
                                     adaptive=args.adaptive,
                                     adapt_chunk=(args.adapt_chunk
                                                  if args.adapt_chunk
                                                  is not None else 32768),
                                     forget=(args.forget
                                             if args.forget is not None
                                             else 0.3)))
    sort_data(args.inputfile, args.datafile, args.outputfile, config=cfg,
              train=args.train, n_templates=args.ntemplates, K=args.K,
              nsteps=args.nsteps, train_samples=args.train_samples,
              save_templates=args.save_templates, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
