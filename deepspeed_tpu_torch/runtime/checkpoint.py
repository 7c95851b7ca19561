"""Checkpoint save and load with a crash-safe commit protocol.

Ports ``deepspeed_tpu/runtime/checkpoint.py``: the same commit protocol,
tag validation, newest-valid-tag resume, ``latest`` pointer and
``keep_last_n`` garbage collection, with the port's own state format.

Crash safety: a preemption can land at any byte of a save, so every tag
is written under ``save_dir/.tmp-<tag>`` (invisible to every reader),
then a ``manifest.json`` of per-file CRC32 and size and a ``COMMITTED``
marker are written and fsynced, and one ``os.rename`` publishes the tag.
``load`` verifies marker and manifest and, when a tag is torn, corrupt
or uncommitted, falls back to the newest valid tag by commit time (robust
to a crash between the commit and the ``latest`` update). GC keeps the
newest ``keep_last_n`` checksum-verified tags and never deletes the only
valid one. ``latest`` is written by rank 0 after a barrier, through a
temp file and a rename.

State format (the port's, not the JAX package's orbax tree): every leaf
is a FULL logical array, so a tag saved at one ZeRO stage, rank count or
tensor-parallel degree loads at any other. ``state/<group>.safetensors``
holds one group of leaves (the trainer writes ``params``,
``opt_state.mu`` and ``opt_state.nu``, and ``engine``: the step, scaler
and random stream; a load checks the files' CRCs in parallel),
written with :mod:`~deepspeed_tpu_torch.checkpoint.safetensors_io`;
Python scalars ride in a file's ``__metadata__`` as JSON. A group is a
mapping of tensors (or numpy arrays, or scalars), or :class:`Leaves`,
whose tensors are made one at a time while the file is written: under
ZeRO or tensor parallelism each is a collective gather, which every rank
runs in one order (``safetensors_io.write_order``) while rank 0 writes.
``meta.json`` keeps the JAX package's keys (``tag``, ``client_state``,
``config``, ``version: 2``, optional ``model_version``).

``async_save``: the leaves are copied to the host at the step boundary,
then one writer thread writes and commits the tag; the next save,
:meth:`CheckpointEngine.wait` (``close``) and ``load`` wait for it, and a
failure of the thread is raised there.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import safetensors_io as sio
from ..comm import comm
from ..resilience.retry import RetryBudget, RetryPolicy, retry_call
from ..utils.fileio import fsync_dir as _fsync_dir
from ..utils.fileio import write_json_atomic
from ..utils.logging import log_dist, logger

LATEST_FILE = "latest"
COMMITTED_FILE = "COMMITTED"
MANIFEST_FILE = "manifest.json"
TMP_PREFIX = ".tmp-"
STATE_DIR = "state"
SCALARS_KEY = "scalars"     # a file's __metadata__ entry of JSON scalars

# short jittered retries absorb filesystem flakes; ONE budget per save or
# load, so a degraded backend fails the operation promptly
_FS_RETRY = RetryPolicy(max_attempts=3, backoff_s=0.2, max_backoff_s=2.0,
                        jitter=0.5)
_FS_BUDGET_PER_OP = 6


def _ckpt_dir(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, str(tag))


def _is_multiprocess() -> bool:
    return comm.get_world_size() > 1


def _rank0() -> bool:
    return comm.get_rank() == 0


def _chaos():
    """The installed fault injector, or None (resilience/chaos.py)."""
    from ..resilience.chaos import get_fault_injector

    return get_fault_injector()


def _count(name: str) -> None:
    from ..telemetry.registry import get_registry

    get_registry().counter(name).inc()


# ----------------------------------------------------------------------
# durable small-file IO

def _write_json_durable(path: str, obj: Any) -> None:
    """Commit-protocol JSON: temp + fsync + atomic rename."""
    write_json_atomic(path, obj, fsync=True, indent=2)


def _file_crc32(path: str) -> int:
    return sio.crc32_of(path)


def _walk_files(root: str) -> List[str]:
    """Relative paths of every regular file under ``root``, sorted."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            out.append(os.path.relpath(os.path.join(dirpath, name), root))
    return sorted(out)


# ----------------------------------------------------------------------
# tag validity

def build_manifest(path: str, known: Optional[Mapping[str, Tuple[int, int]]]
                   = None) -> Dict[str, Any]:
    """Per-file checksum manifest over everything currently in ``path``
    (the manifest and marker themselves excluded). ``known`` gives
    ``{rel: (size, crc32)}`` of files whose bytes were checksummed as
    they were written; a file whose size differs is read again."""
    files: Dict[str, Dict[str, Any]] = {}
    known = known or {}
    for rel in _walk_files(path):
        if rel in (MANIFEST_FILE, COMMITTED_FILE):
            continue
        full = os.path.join(path, rel)
        size = os.path.getsize(full)
        if rel in known and known[rel][0] == size:
            crc = known[rel][1]
        else:
            crc = _file_crc32(full)
        files[rel] = {"size": size, "crc32": crc}
    return {"version": 1, "files": files}


def verify_tag(path: str, checksums: bool = True) -> Tuple[bool, str]:
    """Is the tag at ``path`` a complete, committed checkpoint? Returns
    (ok, reason). A tag written before the commit protocol (``state/``
    and no marker) is accepted as legacy: the atomic rename guarantees a
    new-protocol tag at its final path is complete."""
    if not os.path.isdir(path):
        return False, "missing"
    committed = os.path.join(path, COMMITTED_FILE)
    manifest_path = os.path.join(path, MANIFEST_FILE)
    if not os.path.isfile(committed):
        if os.path.isdir(os.path.join(path, STATE_DIR)):
            logger.warning(f"checkpoint {path}: pre-protocol tag (no "
                           f"{COMMITTED_FILE} marker) — accepting as legacy")
            return True, "legacy"
        return False, f"no {COMMITTED_FILE} marker and no state dir"
    if not os.path.isfile(manifest_path):
        return False, f"{COMMITTED_FILE} present but {MANIFEST_FILE} missing"
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return False, f"unreadable manifest: {e}"
    files = manifest.get("files", {})
    for rel, info in files.items():
        full = os.path.join(path, rel)
        if not os.path.isfile(full):
            return False, f"missing file {rel}"
        if os.path.getsize(full) != info["size"]:
            return False, (f"size mismatch for {rel}: "
                           f"{os.path.getsize(full)} != {info['size']}")
    if checksums and files:
        # one file a thread: zlib releases the GIL on large reads
        rels = sorted(files)
        with ThreadPoolExecutor(min(8, len(rels)),
                                thread_name_prefix="dst-verify") as pool:
            crcs = list(pool.map(
                lambda r: _file_crc32(os.path.join(path, r)), rels))
        for rel, crc in zip(rels, crcs):
            if crc != files[rel]["crc32"]:
                return False, f"checksum mismatch for {rel}"
    return True, "ok"


def _commit_time(path: str) -> float:
    try:
        with open(os.path.join(path, COMMITTED_FILE)) as f:
            return float(json.load(f).get("time", 0.0))
    except (OSError, ValueError, json.JSONDecodeError):
        try:
            return os.path.getmtime(path)
        except OSError:
            return 0.0


def list_tags(save_dir: str) -> List[str]:
    """Candidate tags under ``save_dir``, newest committed first (commit
    time from the marker; the directory's mtime for legacy tags). Temp
    directories are never candidates."""
    if not os.path.isdir(save_dir):
        return []
    cands = []
    for name in os.listdir(save_dir):
        if name.startswith(TMP_PREFIX) or name == LATEST_FILE:
            continue
        path = os.path.join(save_dir, name)
        if os.path.isdir(path):
            cands.append((_commit_time(path), name))
    return [name for _t, name in sorted(cands, reverse=True)]


def tag_model_version(path: str) -> Optional[int]:
    """The ``model_version`` a tag's meta records (None when absent).
    Reads identity only; it does not validate."""
    try:
        with open(os.path.join(path, "meta.json")) as f:
            v = json.load(f).get("model_version")
    except (OSError, ValueError, json.JSONDecodeError):
        return None
    return int(v) if v is not None else None


def find_valid_tag(save_dir: str, checksums: bool = True) -> Optional[str]:
    """Newest tag that passes :func:`verify_tag`, in commit-time order
    rather than by the ``latest`` pointer (a crash between commit and
    pointer update leaves the pointer stale, not the data)."""
    for tag in list_tags(save_dir):
        ok, reason = verify_tag(_ckpt_dir(save_dir, tag), checksums=checksums)
        if ok:
            return tag
        logger.warning(f"checkpoint tag '{tag}' skipped: {reason}")
    return None


# ----------------------------------------------------------------------
# the state files

@dataclass
class Leaves:
    """One state file's tensors, made one at a time as it is written:
    ``specs`` are (name, dtype, shape) of the full logical arrays;
    ``make(name)`` returns one (on any device). Under several ranks
    ``make`` may be collective: every rank calls it for every name in
    ``safetensors_io.write_order``; rank 0's results are written."""

    specs: List[Tuple[str, torch.dtype, Tuple[int, ...]]]
    make: Callable[[str], torch.Tensor]
    scalars: Dict[str, Any] = field(default_factory=dict)


def _as_tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":    # an ml_dtypes array: keep the bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _is_scalar(v: Any) -> bool:
    return isinstance(v, (bool, int, float, str)) or v is None


def _flatten(tree: Mapping[str, Any], prefix: str = ""
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(tensors, scalars) of a nested mapping, keys joined with '/'."""
    tensors: Dict[str, torch.Tensor] = {}
    scalars: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            t, s = _flatten(v, key + "/")
            tensors.update(t)
            scalars.update(s)
        elif _is_scalar(v):
            scalars[key] = v
        else:
            tensors[key] = _as_tensor(v)
    return tensors, scalars


def _as_leaves(group: Any) -> Leaves:
    if isinstance(group, Leaves):
        return group
    if not isinstance(group, Mapping):
        group = {"value": group}
    tensors, scalars = _flatten(group)
    return Leaves([(n, t.dtype, tuple(t.shape)) for n, t in tensors.items()],
                  tensors.__getitem__, scalars)


def _groups(state: Mapping[str, Any]) -> Dict[str, Leaves]:
    """A state mapping as files: each :class:`Leaves` or mapping value is
    a file of its own; the other top-level values share ``tree``."""
    files: Dict[str, Leaves] = {}
    loose: Dict[str, Any] = {}
    for k, v in state.items():
        if isinstance(v, (Leaves, Mapping)):
            files[k] = _as_leaves(v)
        else:
            loose[k] = v
    if loose:
        files["tree"] = _as_leaves(loose)
    return files


def _host_copies(files: Dict[str, Leaves]) -> Dict[str, Leaves]:
    """Every file's tensors made now, as host copies (async saves)."""
    out = {}
    for key, lv in files.items():
        made = {}
        for name in sio.write_order(lv.specs):
            t = lv.make(name)
            made[name] = t.detach().to("cpu", copy=True) \
                if _rank0() else None
        out[key] = Leaves(lv.specs, made.__getitem__, dict(lv.scalars))
    return out


def _write_files(state_path: str, files: Dict[str, Leaves], write: bool
                 ) -> Dict[str, Tuple[int, int]]:
    """Make every leaf (every rank, in ``sio.write_order``) and, where
    ``write``, stream them into ``state/<key>.safetensors``. Returns the
    ``{rel: (size, crc32)}`` of the files written."""
    known = {}
    if write:
        os.makedirs(state_path, exist_ok=True)
    for key, lv in files.items():
        meta = {SCALARS_KEY: json.dumps(lv.scalars, sort_keys=True)}
        w = sio.StreamWriter(os.path.join(state_path, f"{key}.safetensors"),
                             lv.specs, meta) if write else None
        for name in sio.write_order(lv.specs):
            t = lv.make(name)
            if w is not None:
                w.write(name, t)
            del t
        if w is not None:
            w.close(fsync=True)
            known[os.path.join(STATE_DIR, f"{key}.safetensors")] = (
                w.size, w.crc32)
    return known


def read_state(path: str, groups: Optional[List[str]] = None
               ) -> Dict[str, Dict[str, Any]]:
    """The state files of a tag directory: ``{group: {name: tensor,
    ...scalars}}`` (tensors view a map of the file). ``groups`` limits
    which files are read."""
    state_path = os.path.join(path, STATE_DIR)
    out: Dict[str, Dict[str, Any]] = {}
    for fname in sorted(os.listdir(state_path)):
        key, ext = os.path.splitext(fname)
        if ext != ".safetensors" or (groups is not None
                                     and key not in groups):
            continue
        full = os.path.join(state_path, fname)
        tree: Dict[str, Any] = dict(sio.load_file(full))
        tree.update(json.loads(sio.metadata(full).get(SCALARS_KEY, "{}")))
        out[key] = tree
    return out


class CheckpointEngine:
    """Checkpoint engine with atomic commits.

    Layout under ``save_dir/tag/``:
      state/         — ``<group>.safetensors`` files of full logical arrays
      meta.json      — config snapshot + client state
      manifest.json  — per-file {size, crc32} over state/ + meta.json
      COMMITTED      — commit marker {tag, time, n_files}
    ``save_dir/latest`` holds the most recent tag, written by rank 0 after
    a barrier, through a temp file and a rename.
    """

    def __init__(self, async_save: bool = False, keep_last_n: int = 0,
                 verify_checksums: bool = True):
        self.async_save = bool(async_save)
        self.keep_last_n = int(keep_last_n)
        self.verify_checksums = bool(verify_checksums)
        # committed tags are immutable: path -> commit time verified OK, so
        # GC never re-checksums a tag it (or save) already verified
        self._verified: Dict[str, float] = {}
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        #: seconds and bytes of the last save's phases: gather (async
        #: saves' host copies), write, commit, total, bytes
        self.last_save: Dict[str, float] = {}
        self.last_verify_s = 0.0

    @staticmethod
    def _barrier() -> None:
        if _is_multiprocess():
            comm.barrier()

    def wait(self) -> None:
        """Wait for an async save's writer thread; raise its failure."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    @staticmethod
    def _clean_stale_tmp(save_dir: str) -> None:
        """Remove temp dirs abandoned by crashed saves."""
        for name in os.listdir(save_dir):
            if name.startswith(TMP_PREFIX):
                logger.warning(f"removing stale checkpoint temp dir {name}")
                shutil.rmtree(os.path.join(save_dir, name),
                              ignore_errors=True)

    def save(self, save_dir: str, tag: str, state: Mapping[str, Any],
             client_state: Optional[Dict[str, Any]] = None,
             config_snapshot: Optional[Dict[str, Any]] = None,
             model_version: Optional[int] = None) -> str:
        """Write ``state`` (see the module docstring) as tag ``tag`` under
        ``save_dir`` and commit it. Every rank calls it. Returns the tag's
        final path (with ``async_save``, once the host copies are taken;
        the tag appears when the writer thread commits it)."""
        self.wait()
        tag = str(tag)
        t0 = time.perf_counter()
        meta = {"tag": tag, "client_state": client_state or {},
                "config": config_snapshot or {}, "version": 2}
        if model_version is not None:
            # rollout identity: hot_swap_checkpoint reads it back
            meta["model_version"] = int(model_version)
        files = _groups(state)
        final = _ckpt_dir(save_dir, tag)
        if self.async_save:
            files = _host_copies(files)
            self.last_save = {"gather_s": time.perf_counter() - t0}
            if not _rank0():
                return final

            def run():
                try:
                    self._write_and_commit(save_dir, tag, files, meta, t0,
                                           collective=False)
                except BaseException as e:   # raised again by wait()
                    self._writer_error = e

            self._writer = threading.Thread(target=run, daemon=True,
                                            name="dst-ckpt-writer")
            self._writer.start()
            return final
        self._write_and_commit(save_dir, tag, files, meta, t0,
                               collective=_is_multiprocess())
        return final

    def _write_and_commit(self, save_dir: str, tag: str,
                          files: Dict[str, Leaves], meta: Dict[str, Any],
                          t0: float, collective: bool) -> None:
        rank0 = _rank0()
        final = _ckpt_dir(save_dir, tag)
        tmp = os.path.join(save_dir, f"{TMP_PREFIX}{tag}")
        if rank0:
            os.makedirs(save_dir, exist_ok=True)
            self._clean_stale_tmp(save_dir)
            os.makedirs(tmp, exist_ok=True)
        if collective:
            self._barrier()
        state_path = os.path.join(tmp, STATE_DIR)
        budget = RetryBudget(_FS_BUDGET_PER_OP)
        t_write = time.perf_counter()
        if collective:
            # the leaves are gathered as they are written: a rank that
            # retried the write alone would leave the others' gathers
            # waiting. A failed collective write needs a restart
            known = _write_files(state_path, files, rank0)
        else:
            known = retry_call(self._rewrite_files, state_path, files,
                               policy=_FS_RETRY, op="checkpoint_save",
                               budget=budget)
        write_s = time.perf_counter() - t_write
        if rank0:
            retry_call(_write_json_durable, os.path.join(tmp, "meta.json"),
                       meta, policy=_FS_RETRY, op="checkpoint_fs",
                       budget=budget)
        # every rank's part is durable before rank 0 publishes the tag
        if collective:
            self._barrier()

        inj = _chaos()
        if inj is not None:
            inj.on_save_phase("before_commit", tag)
        t_commit = time.perf_counter()
        if rank0:
            self._commit(tmp, final, budget, known)
        commit_s = time.perf_counter() - t_commit
        if collective:
            self._barrier()

        corrupted = False
        if inj is not None:
            # a crash here lands AFTER the durable commit: the tag must
            # survive and auto-resume must find it without 'latest'
            inj.on_save_phase("after_commit", tag)
            corrupted = inj.maybe_corrupt(final) if rank0 else False
        if rank0 and not corrupted:
            # hashed while building its manifest: never re-read by GC (set
            # after the chaos window, so an injected corruption is not
            # carried past GC's checksum gate)
            self._verified[final] = _commit_time(final)
        if rank0:
            retry_call(self._write_latest, save_dir, tag,
                       policy=_FS_RETRY, op="checkpoint_fs", budget=budget)
            self._gc(save_dir, just_saved=tag)
        self.last_save = {
            **self.last_save, "write_s": write_s, "commit_s": commit_s,
            "total_s": time.perf_counter() - t0,
            "bytes": float(sum(size for size, _ in known.values()))}
        _count("checkpoint/saves")
        log_dist(f"Saved checkpoint {final} (committed)")

    @staticmethod
    def _rewrite_files(state_path: str, files: Dict[str, Leaves]):
        if os.path.exists(state_path):
            shutil.rmtree(state_path)
        return _write_files(state_path, files, True)

    def _commit(self, tmp: str, final: str,
                budget: Optional[RetryBudget] = None,
                known: Optional[Mapping[str, Tuple[int, int]]] = None
                ) -> None:
        """Manifest + marker + fsync + atomic publish."""
        manifest = build_manifest(tmp, known)
        retry_call(_write_json_durable, os.path.join(tmp, MANIFEST_FILE),
                   manifest, policy=_FS_RETRY, op="checkpoint_fs",
                   budget=budget)
        marker = {"tag": os.path.basename(final), "time": time.time(),
                  "n_files": len(manifest["files"])}
        retry_call(_write_json_durable, os.path.join(tmp, COMMITTED_FILE),
                   marker, policy=_FS_RETRY, op="checkpoint_fs",
                   budget=budget)
        _fsync_dir(tmp)
        trash = None
        if os.path.exists(final):
            # replacing a tag: move the old one aside first (the new one
            # is complete in tmp), publish, then drop the old; the trash
            # name is a temp name, reaped by the next save if we crash
            trash = os.path.join(
                os.path.dirname(final) or ".",
                f"{TMP_PREFIX}{os.path.basename(final)}-replaced")
            shutil.rmtree(trash, ignore_errors=True)
            os.rename(final, trash)
        os.rename(tmp, final)
        _fsync_dir(os.path.dirname(final) or ".")
        if trash is not None:
            shutil.rmtree(trash, ignore_errors=True)

    @staticmethod
    def _write_latest(save_dir: str, tag: str) -> None:
        tmp = os.path.join(save_dir, LATEST_FILE + ".tmp")
        with open(tmp, "w") as f:
            f.write(str(tag))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(save_dir, LATEST_FILE))

    def _verified_for_keep(self, path: str) -> bool:
        """Checksum verification with a memo (committed tags are
        immutable): one checksum pass per NEW tag, not keep_last_n x the
        checkpoint's size of reads every save."""
        t = _commit_time(path)
        if self._verified.get(path) == t and t > 0:
            return True
        ok = verify_tag(path, checksums=self.verify_checksums)[0]
        if ok:
            self._verified[path] = t
        return ok

    def _gc(self, save_dir: str, just_saved: Optional[str] = None) -> None:
        """Keep the newest ``keep_last_n`` valid tags. The tags counted
        toward the quota are checksum-verified (a bit-flipped tag must not
        pass for the last good checkpoint and license deleting the real
        one); invalid tags are left as evidence; the only valid
        checkpoint is never deleted."""
        if self.keep_last_n <= 0:
            return
        keep = max(self.keep_last_n, 1)
        confirmed = 0
        doomed: List[str] = []
        for tag in list_tags(save_dir):
            path = _ckpt_dir(save_dir, tag)
            if confirmed < keep:
                if self._verified_for_keep(path):
                    confirmed += 1
            elif verify_tag(path, checksums=False)[0]:
                doomed.append(tag)
        if confirmed == 0:
            return
        for tag in doomed:
            if tag == just_saved:
                continue
            logger.info(f"checkpoint GC: removing old tag '{tag}'")
            self._verified.pop(_ckpt_dir(save_dir, tag), None)
            shutil.rmtree(_ckpt_dir(save_dir, tag), ignore_errors=True)
            _count("checkpoint/gc_removed")

    # ------------------------------------------------------------------
    def load(self, load_dir: str, tag: Optional[str] = None,
             groups: Optional[List[str]] = None, quiet: bool = False
             ) -> Optional[Dict[str, Any]]:
        """``{"state": {group: {name: tensor, ...}}, "meta", "tag"}`` of a
        tag (``groups`` limits the state files read), or None. With
        ``tag=None`` the newest valid tag is chosen; an explicit ``tag``
        that fails verification returns None (no silent substitution).
        ``quiet`` leaves a missing ``load_dir`` unlogged (auto-resume).
        Every rank calls it: under several ranks rank 0 alone chooses and
        verifies the tag and broadcasts its choice, so all ranks restore
        the same tag (or none) whatever each would have seen alone."""
        self.wait()
        t0 = time.perf_counter()
        if _is_multiprocess():
            mine = {"tag": self._choose(load_dir, tag, quiet)} \
                if _rank0() else None
            chosen = comm.broadcast_record(mine, op="checkpoint_tag")["tag"]
        else:
            chosen = self._choose(load_dir, tag, quiet)
        if chosen is None:
            return None
        #: seconds of the last load's tag choice (rank 0's CRC pass)
        self.last_verify_s = time.perf_counter() - t0
        return self._restore(load_dir, chosen, groups)

    def _choose(self, load_dir: str, tag: Optional[str],
                quiet: bool) -> Optional[str]:
        """The tag :meth:`load` restores: ``tag`` once verified, else the
        newest valid one; None when there is none."""
        if not os.path.isdir(load_dir):
            if not quiet:
                logger.warning(f"checkpoint dir {load_dir} not found; "
                               f"nothing to load")
            return None
        if tag is not None:
            ok, reason = verify_tag(_ckpt_dir(load_dir, str(tag)),
                                    checksums=self.verify_checksums)
            if not ok:
                logger.warning(f"checkpoint tag '{tag}' invalid: {reason}")
                _count("checkpoint/invalid_tags")
                return None
            return str(tag)
        chosen = find_valid_tag(load_dir, checksums=self.verify_checksums)
        if chosen is None:
            logger.warning(f"no valid checkpoint tag in {load_dir}")
        return chosen

    def _restore(self, load_dir: str, tag: str,
                 groups: Optional[List[str]]) -> Optional[Dict[str, Any]]:
        path = _ckpt_dir(load_dir, tag)
        if not os.path.isdir(os.path.join(path, STATE_DIR)):
            logger.warning(f"Checkpoint dir {path}/{STATE_DIR} not found")
            return None
        state = retry_call(read_state, path, groups, policy=_FS_RETRY,
                           op="checkpoint_load",
                           budget=RetryBudget(_FS_BUDGET_PER_OP))
        meta = {}
        meta_path = os.path.join(path, "meta.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        log_dist(f"Loaded checkpoint {path}")
        return {"state": state, "meta": meta, "tag": tag}


def validate_tag_consistency(tag: str, mode: str = "Warn") -> None:
    """Tag validation across processes (the reference's
    ``_checkpoint_tag_validation``): rank 0's tag is broadcast and
    compared on every rank."""
    if not _is_multiprocess() or mode == "Ignore":
        return
    got = [tag if _rank0() else None]
    try:
        torch.distributed.broadcast_object_list(got, src=0)
    except Exception as e:  # noqa: BLE001 - a backend that cannot send it
        logger.warning(f"tag validation skipped: {e}")
        return
    if got[0] != tag:
        msg = f"Checkpoint tag '{tag}' differs across processes"
        if mode == "Fail":
            raise RuntimeError(msg)
        logger.warning(msg)


def consolidate_full_state(params, dtype=None) -> Dict[str, torch.Tensor]:
    """Host copies of full arrays, cast to ``dtype`` when given — the
    ``zero_to_fp32`` / ``save_16bit_model`` read-out. ``params`` is a
    ``{name: tensor}`` mapping (a trainer's ``full_params()``) or an
    iterable of ``(name, tensor)`` pairs made one at a time (a trainer's
    leaves gathered as they are asked for)."""
    items = params.items() if isinstance(params, Mapping) else params
    return {n: t.detach().to("cpu", dtype=dtype if dtype is not None
                             else t.dtype, copy=True)
            for n, t in items}


__all__ = ["CheckpointEngine", "Leaves", "build_manifest", "verify_tag",
           "list_tags", "find_valid_tag", "tag_model_version",
           "validate_tag_consistency", "consolidate_full_state",
           "read_state", "LATEST_FILE", "COMMITTED_FILE",
           "MANIFEST_FILE", "TMP_PREFIX", "zlib"]
