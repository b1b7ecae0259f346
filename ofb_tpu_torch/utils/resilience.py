"""Auto-resume of the long-running CLIs after a transient failure.

Port of ofb_tpu/utils/resilience.py (framework-free logic). Checkpoint and
resume replay prune decisions deterministically, so the answer to a
*transient infrastructure* error (a decode worker killed, an ECC error that
poisons the CUDA context, a network file system that dropped its handle)
is to start again from ``<output_dir>/running_ckpt``: a fresh ``exec`` of
the same command line with ``--resume --checkpoint``, which rebuilds all
process and device state from the checkpoint as a manual re-launch would.

Never retried:
  * NaN aborts: the engine exits through ``sys.exit(1)`` (SystemExit);
  * model or user errors: anything that matches no transient marker;
  * multi-process runs: one rank re-execing while its peers continue would
    desynchronise the collectives.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Sequence

# Substrings of the messages that such failures raise in a single-process
# PyTorch run; NCCL's are absent because multi-process runs never re-exec.
TRANSIENT_MARKERS: Sequence[str] = (
    "DataLoader worker (pid",       # a decode worker killed or gone
    "uncorrectable ECC error encountered",   # cudaErrorECCUncorrectable
    "busy or unavailable",          # cudaErrorDevicesUnavailable
    "Stale file handle",            # ESTALE from a network file system
    "Connection timed out",         # ETIMEDOUT from a network file system
)

_ENV_LEFT = "OFB_AUTO_RESUME_LEFT"


def is_transient(exc: BaseException) -> bool:
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in TRANSIENT_MARKERS)


def _command() -> list:
    """The interpreter and how this program was started: `-m <module>` for
    a CLI run as a module (its file alone would lose the package)."""
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    if spec is not None and spec.name:
        return [sys.executable, "-m", spec.name]
    return [sys.executable, sys.argv[0]]


def _resume_argv(checkpoint: str) -> list:
    # argparse keeps the last occurrence of an option, so appending wins
    return _command() + sys.argv[1:] + ["--resume", "--checkpoint",
                                        checkpoint]


def _fresh_argv() -> list:
    """argv for a from-scratch re-exec: any --resume / --checkpoint an
    earlier auto-resume appended is stripped (appending cannot undo a
    store_true flag)."""
    argv, skip = [], False
    for a in sys.argv[1:]:
        if skip:
            skip = False
            continue
        if a == "--resume" or a.startswith("--resume="):
            continue
        if a == "--checkpoint":
            skip = True
            continue
        if a.startswith("--checkpoint="):
            continue
        argv.append(a)
    return _command() + argv


def _multi_process() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def run_with_auto_resume(run: Callable, args) -> None:
    """Run ``run(args)``; on a transient error, re-exec this CLI with
    ``--resume --checkpoint <output_dir>/running_ckpt`` (or afresh when no
    checkpoint was written yet). Budgeted by ``args.auto_resume``, the
    attempts left carried across execs in ``OFB_AUTO_RESUME_LEFT``."""
    left = int(os.environ.get(_ENV_LEFT,
                              str(getattr(args, "auto_resume", 0))))
    try:
        run(args)
        return
    except Exception as exc:  # noqa: BLE001 - filtered below
        if left <= 0 or not is_transient(exc) or _multi_process():
            raise
        out = getattr(args, "output_dir", "") or ""
        rck = os.path.join(out, "running_ckpt")
        if os.path.exists(os.path.join(rck, "meta.json")):
            argv = _resume_argv(rck)
            how = f"--resume --checkpoint {rck}"
        else:
            argv = _fresh_argv()
            how = "a fresh start (no running_ckpt yet)"
        print(f"[auto-resume] transient failure "
              f"({type(exc).__name__}: {str(exc).splitlines()[0][:200]}); "
              f"re-exec with {how} ({left - 1} attempts left)", flush=True)
        os.environ[_ENV_LEFT] = str(left - 1)
        sys.stdout.flush()
        sys.stderr.flush()
        os.execve(sys.executable, argv, dict(os.environ))
