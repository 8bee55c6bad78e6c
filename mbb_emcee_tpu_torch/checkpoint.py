"""Mid-sampling checkpoint / resume of the stretch-move runs.

Torch twin of mbb_emcee_tpu/checkpoint.py for the single fit and the batch
tier: the production run is segmented on the host, and after each segment
the chain block and the full sampler state are flushed to an HDF5 file, so
a killed run resumes where its last flush stopped. The sampler state is the
port's SamplerState / MultiSamplerState: positions, lnprob, accept and step
counters, and the Philox key (`seed`) with its stream position (`step`)
in place of the JAX package's PRNG key data. Every launch continues the
Philox stream at `step`, so a resumed run is bitwise the uninterrupted one.

Layout (the reference's, version 2): root attrs (version, prng_impl,
[multi,] run meta), /State/..., /Segments/segNNNNN/{Chain,Lnp} appended per
flush, ordered by the integer suffix. Files are written to a temporary name
and renamed, so a kill mid-write leaves the previous checkpoint intact.
`prng_impl` names the port's generator, so a file of the JAX package (whose
state is a JAX key) is refused on load, and the JAX package refuses the
port's. h5py is imported inside the functions: only checkpoint I/O needs it.

The batch tier's parallel-tempering and HMC runs flush through
save_tier_checkpoint / load_tier_checkpoint: the same layout with a `tier`
attr, arbitrary named State arrays (the Philox `seed` and `step` in place of
a JAX key) and an Aux group (ladders, evidence accumulators).
"""

from __future__ import annotations

import hashlib
import os
import secrets

import numpy as np
import torch

from mbb_emcee_tpu_torch.sampler import MultiSamplerState, SamplerState

_VERSION = 2
# The generator the port's samplers draw from (ops/philox.py and the
# kernels): Philox-4x32-10 keyed by a 64-bit seed, counter (step, half +
# 2 * source, lane, step >> 32).
PRNG_IMPL = "philox4x32_10"


def _segment_order(group):
    """Segment names ordered by their integer suffix (a lexicographic sort
    would put seg100000 before seg99999 once the zero padding runs out)."""
    return sorted(group, key=lambda n: int(n[3:]))


def new_run_id() -> str:
    """Unique id tying a checkpoint file's segments to ONE run: a fresh run
    flushing to a path that still holds an unrelated old checkpoint
    overwrites it, never adopts its segments as a prefix."""
    return secrets.token_hex(8)


def _decode(v):
    return v.decode() if isinstance(v, bytes) else v


def _write_segments(f, prev_path, chain_blocks, lnp_blocks, axis):
    """Flush chain/lnp blocks as APPEND-ONLY segments: the records already
    in the previous checkpoint file of the same run are copied raw
    (compressed chunks move without re-filtering) and only the records
    beyond them are compressed, so each flush gzips O(new segment)."""
    import h5py
    segs = f.create_group("Segments")
    nseg = nrec_prev = 0
    run_id = _decode(f.attrs.get("run_id"))
    if prev_path is not None and os.path.exists(prev_path):
        try:
            with h5py.File(prev_path, "r") as prev:
                prev_id = _decode(prev.attrs.get("run_id"))
                if (run_id is None or prev_id is None
                        or str(prev_id) != str(run_id)):
                    raise OSError("different run; flush fresh")
                if "Segments" in prev:
                    for name in _segment_order(prev["Segments"]):
                        prev.copy(prev["Segments"][name], segs, name=name)
                        nrec_prev += segs[name]["Chain"].shape[axis]
                        nseg += 1
        except OSError:
            # another run's file, or an unreadable one: flush everything
            for name in list(segs):
                del segs[name]
            nseg = nrec_prev = 0
    total = sum(b.shape[axis] for b in chain_blocks)
    new = total - nrec_prev
    if new > 0:
        # only the tail blocks covering the new records are touched
        tail_c, tail_l, have = [], [], 0
        for b_c, b_l in zip(reversed(chain_blocks), reversed(lnp_blocks)):
            tail_c.append(b_c)
            tail_l.append(b_l)
            have += b_c.shape[axis]
            if have >= new:
                break
        chain = np.concatenate(tail_c[::-1], axis=axis)
        lnp = np.concatenate(tail_l[::-1], axis=axis)
        sl = [slice(None)] * chain.ndim
        sl[axis] = slice(have - new, None)
        g = segs.create_group(f"seg{nseg:05d}")
        g.create_dataset("Chain", data=chain[tuple(sl)],
                         compression="gzip", compression_opts=4)
        g.create_dataset("Lnp", data=lnp[tuple(sl[:lnp.ndim])],
                         compression="gzip", compression_opts=4)


def _read_segments(f, axis):
    """(chain, lnp) concatenated from the segments (or the version-1
    datasets); (None, None) if nothing was flushed."""
    if "Segments" in f and len(f["Segments"]):
        names = _segment_order(f["Segments"])
        chain = np.concatenate(
            [np.asarray(f["Segments"][n]["Chain"]) for n in names],
            axis=axis)
        lnp = np.concatenate(
            [np.asarray(f["Segments"][n]["Lnp"]) for n in names], axis=axis)
        return chain, lnp
    if "ChainSoFar" in f:
        return np.asarray(f["ChainSoFar"]), np.asarray(f["LnpSoFar"])
    return None, None


def data_fingerprint(*arrays) -> str:
    """Content hash of the photometry (and response pack) a run was
    sampling, stored in the checkpoint and re-checked on resume; the same
    hash as the JAX package's for the same inputs."""
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"\x00none")
            continue
        arr = np.asarray(a)
        if arr.dtype.kind in "fiub":
            arr = np.ascontiguousarray(arr, np.float64)
            h.update(arr.shape.__repr__().encode())
            h.update(arr.tobytes())
        else:  # band names etc.
            h.update(repr(arr.tolist()).encode())
    return h.hexdigest()[:32]


def spec_fingerprint(spec, shape, a) -> str:
    """Content hash of the posterior a run was sampling: box limits,
    priors, fixed parameters, upper-limit mask, model shape flags and the
    stretch parameter a (the JAX package's hash)."""
    uplim = (None if spec.uplim_bands is None
             else np.asarray(spec.uplim_bands))
    return data_fingerprint(
        spec.lower, spec.upper, spec.fixed, spec.fixed_values,
        spec.prior_mean, spec.prior_isigma, uplim,
        np.asarray([float(shape.opthin), float(shape.noalpha),
                    float(shape.wavenorm), float(a)]))


def _np(t):
    return t.detach().cpu().numpy()


def _write(path, multi, meta, state_arrays, chain_blocks, lnp_blocks,
           axis):
    import h5py
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.attrs["version"] = _VERSION
        f.attrs["prng_impl"] = PRNG_IMPL
        if multi:
            f.attrs["multi"] = True
        for k, v in meta.items():
            f.attrs[k] = v
        st = f.create_group("State")
        for name, arr in state_arrays.items():
            st.create_dataset(name, data=arr)
        if chain_blocks:
            _write_segments(f, path, chain_blocks, lnp_blocks, axis=axis)
    os.replace(tmp, path)


def _state_arrays(state):
    return {"naccept": _np(state.naccept),
            "nsteps": int(state.nsteps),
            "seed": np.uint64(int(state.seed) & (2 ** 64 - 1)),
            "step": np.int64(state.step)}


def save_checkpoint(path, state: SamplerState, chain_blocks, lnp_blocks,
                    meta: dict):
    """Write/overwrite a single-fit checkpoint atomically. chain_blocks are
    (nrec, nwalkers, nfree) numpy arrays, concatenated on the record
    axis."""
    arrays = {"pos_a": _np(state.pos_a), "pos_b": _np(state.pos_b),
              "lnp_a": _np(state.lnp_a), "lnp_b": _np(state.lnp_b),
              **_state_arrays(state)}
    _write(path, False, meta, arrays, chain_blocks, lnp_blocks, axis=0)


def _open_state(f, path, multi):
    """Root meta of a checkpoint written by this package, after refusing
    the other kind (single/multi) and another generator's file."""
    if bool(f.attrs.get("multi", False)) != multi:
        raise ValueError(
            f"{path} is a single-fit checkpoint, not a MultiFitter one"
            if multi else
            f"{path} is a MultiFitter checkpoint, not a single-fit one")
    impl = _decode(f.attrs.get("prng_impl"))
    if impl != PRNG_IMPL or "seed" not in f["State"]:
        raise ValueError(
            f"{path} was written by another sampler (prng_impl={impl!r}; "
            f"mbb_emcee_tpu_torch draws {PRNG_IMPL!r}): its stream cannot be "
            f"continued here -- start a fresh run")
    meta = {k: f.attrs[k] for k in f.attrs
            if k not in ("version", "prng_impl", "multi")}
    meta["prng_impl"] = impl
    return meta


def _t(f, name, device):
    return torch.as_tensor(np.asarray(f["State"][name]), device=device)


def _counters(f):
    st = f["State"]
    return dict(nsteps=int(np.asarray(st["nsteps"])),
                seed=int(np.asarray(st["seed"])),
                step=int(np.asarray(st["step"])))


def load_checkpoint(path, device="cpu"):
    """Returns (SamplerState on `device`, chain_so_far, lnp_so_far,
    meta). It only reads a file, so `device` defaults to the CPU: the
    fitter that resumes names its own device."""
    import h5py
    with h5py.File(path, "r") as f:
        meta = _open_state(f, path, multi=False)
        state = SamplerState(
            pos_a=_t(f, "pos_a", device), pos_b=_t(f, "pos_b", device),
            lnp_a=_t(f, "lnp_a", device), lnp_b=_t(f, "lnp_b", device),
            naccept=_t(f, "naccept", device), **_counters(f))
        chain, lnp = _read_segments(f, axis=0)
    return state, chain, lnp, meta


def save_multi_checkpoint(path, state: MultiSamplerState, chain_blocks,
                          lnp_blocks, meta: dict):
    """Batch (MultiFitter) checkpoint: the MultiSamplerState and the
    per-source chain blocks (S, nrec, nw, nfree), concatenated on the
    record axis (axis 1), written atomically."""
    arrays = {"pos": _np(state.pos), "lnp": _np(state.lnp),
              **_state_arrays(state)}
    _write(path, True, meta, arrays, chain_blocks, lnp_blocks, axis=1)


def load_multi_checkpoint(path, device="cpu"):
    """Returns (MultiSamplerState on `device`, chain_so_far, lnp_so_far,
    meta). Like load_checkpoint it only reads a file: `device` defaults to
    the CPU."""
    import h5py
    with h5py.File(path, "r") as f:
        meta = _open_state(f, path, multi=True)
        state = MultiSamplerState(
            pos=_t(f, "pos", device), lnp=_t(f, "lnp", device),
            naccept=_t(f, "naccept", device), **_counters(f))
        chain, lnp = _read_segments(f, axis=1)
    return state, chain, lnp, meta


def production(run_mcmc, burn, nsteps, thin, device, checkpoint=None,
               interval=100, resuming=False, meta=None, multi=False,
               verbose=False):
    """The production run of MBBFitter.run and MultiFitter.run:
    `run_mcmc(state, n, thin)` from `burn()`'s state. With `checkpoint` a
    path, it runs in segments of `interval` records and flushes the chain
    so far and the state after each (save_checkpoint, or
    save_multi_checkpoint when `multi`); `resuming` starts instead from the
    checkpoint there, after refusing a file whose geometry, engine, data or
    posterior differ from this run's `meta` (later flushes take over its
    run_id). Returns (state, chain, lnp) with the whole chain on
    `device`."""
    if checkpoint is None:
        return run_mcmc(burn(), nsteps, thin)
    if multi:
        load, save, axis = load_multi_checkpoint, save_multi_checkpoint, 1
        geometry = ("nwalkers", "nsources", "thin")
    else:
        load, save, axis = load_checkpoint, save_checkpoint, 0
        geometry = ("nwalkers", "thin")
    chain_blocks, lnp_blocks = [], []
    done = 0
    if resuming:
        state, chain, lnp, got = load(checkpoint, device=device)
        if any(int(got.get(k, meta[k])) != meta[k] for k in geometry):
            raise ValueError("checkpoint geometry does not match this fitter")
        check_resume_meta(got, {k: meta[k] for k in (
            "sampler_backend", "prng_impl", "data_fingerprint",
            "spec_fingerprint")}, checkpoint)
        if got.get("run_id") is not None:
            meta["run_id"] = got["run_id"]
        if chain is not None:
            chain_blocks.append(chain)
            lnp_blocks.append(lnp)
            done = chain.shape[axis] * thin
    else:
        state = burn()
    seg = max(int(interval), 1) * thin
    while done < nsteps:
        n = min(seg, nsteps - done)
        state, c, l = run_mcmc(state, n, thin)
        chain_blocks.append(_np(c))
        lnp_blocks.append(_np(l))
        done += n
        save(checkpoint, state, chain_blocks, lnp_blocks, meta)
        if verbose:
            from mbb_emcee_tpu_torch.utils.log import enable_console
            what = f" x {state.pos.shape[0]} sources" if multi else ""
            enable_console().info(
                f"  checkpoint: {done}/{nsteps} steps{what} -> {checkpoint}")
    return (state,
            torch.as_tensor(np.concatenate(chain_blocks, axis=axis),
                            device=device),
            torch.as_tensor(np.concatenate(lnp_blocks, axis=axis),
                            device=device))


def check_resume_meta(meta, expect: dict, path):
    """Refuse resuming under another engine, data or posterior than the
    one that wrote the checkpoint: splicing chains from different samplers
    or targets would silently break the same-seed, same-chain contract."""
    for k, want in expect.items():
        got = _decode(meta.get(k))
        if got is not None and str(got) != str(want):
            raise ValueError(
                f"checkpoint {path} was written with {k}={got!r}; this "
                f"fitter is configured with {k}={want!r} -- resume with "
                f"the original configuration (or start a fresh run)")


def save_tier_checkpoint(path, tier, state_arrays, chain_blocks, lnp_blocks,
                         meta: dict, axis=1, aux_arrays=None):
    """Checkpoint of the batch tier's PT / HMC runs: the State group holds
    the named per-source arrays of `state_arrays` (the Philox `seed` and
    `step` among them), chain blocks append through the stretch tiers'
    O(new)-gzip segments (concatenated on `axis`), and `aux_arrays` (PT's
    ladders and stepping-stone accumulators) ride in an Aux group. Written
    atomically."""
    import h5py
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.attrs["version"] = _VERSION
        f.attrs["prng_impl"] = PRNG_IMPL
        f.attrs["multi"] = True
        f.attrs["tier"] = tier
        for k, v in meta.items():
            f.attrs[k] = v
        st = f.create_group("State")
        for name, arr in state_arrays.items():
            st.create_dataset(name, data=arr)
        if aux_arrays:
            ax = f.create_group("Aux")
            for name, arr in aux_arrays.items():
                ax.create_dataset(name, data=np.asarray(arr))
        if chain_blocks:
            _write_segments(f, path, chain_blocks, lnp_blocks, axis=axis)
    os.replace(tmp, path)


def load_tier_checkpoint(path, tier):
    """Returns (state_arrays dict, aux_arrays dict, chain_so_far,
    lnp_so_far, meta), all numpy. A file of another tier is refused, and so
    is one of another generator (the JAX package's tier checkpoints hold a
    JAX key)."""
    import h5py
    with h5py.File(path, "r") as f:
        got = _decode(f.attrs.get("tier", b""))
        if got != tier:
            raise ValueError(
                f"{path} is a {got or 'stretch-move'!r} checkpoint, not "
                f"a {tier!r} one")
        meta = _open_state(f, path, multi=True)
        meta.pop("tier", None)
        state = {name: np.asarray(f["State"][name]) for name in f["State"]}
        aux = ({name: np.asarray(f["Aux"][name]) for name in f["Aux"]}
               if "Aux" in f else {})
        chain, lnp = _read_segments(f, axis=1)
    return state, aux, chain, lnp, meta
