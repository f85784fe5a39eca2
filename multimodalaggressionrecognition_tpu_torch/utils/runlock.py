"""Exclusive run-directory lock (the JAX package's utils/runlock.py): one
live trainer per run dir.

`--run_name` pins a stable run directory so that a relaunch resumes from
its checkpoints (cli/common.py run_training), which makes a double start an
operational hazard: two live trainers writing one run dir overwrite each
other's checkpoints.  The lock is a kernel flock(2) on
`<run_dir>/.runlock.p<slot>` (slot 0 for a single-process trainer).  flock
leaves liveness to the kernel: the lock goes with its process however that
process ends (SIGKILL included), so a relaunch after a crash needs no
stale-pid heuristics, and the file is never removed, so two acquirers cannot
race onto two inodes.  A live owner makes the new process exit with a
message naming its host:pid.  flock is advisory and not reliable across NFS
hosts: the lock guards same-host double starts.
"""

import atexit
import fcntl
import os
import socket

# path -> (fd, release) of the locks this process holds: acquiring again
# (a second fit() of one trainer) returns the same release
_held = {}


def acquire_run_lock(run_dir: str, slot: int = 0):
    """Acquire `run_dir`'s lock for this process; returns an idempotent
    release callable (also registered atexit).  Raises SystemExit if another
    live process holds it."""
    path = os.path.abspath(os.path.join(run_dir, f".runlock.p{slot}"))
    if path in _held:
        return _held[path][1]
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        try:
            with open(path) as f:
                owner = f.read().strip() or "<unknown>"
        except OSError:
            owner = "<unreadable>"
        os.close(fd)
        raise SystemExit(
            f"run dir {run_dir!r} is locked by live trainer {owner} "
            f"({path}). Two trainers on one run dir overwrite each other's "
            "checkpoints: pick a different --run_name. (The lock is a kernel "
            "flock: it goes with the owning process, so a blocked relaunch "
            "means that process is still running.)")
    os.ftruncate(fd, 0)
    os.write(fd, f"{socket.gethostname()}:{os.getpid()}\n".encode())
    os.fsync(fd)

    def release():
        if _held.pop(path, None) is not None:
            # closing the fd drops the flock; the file stays (removing it
            # would let a concurrent acquirer lock a second inode)
            try:
                os.close(fd)
            except OSError:
                pass

    _held[path] = (fd, release)
    atexit.register(release)
    return release
