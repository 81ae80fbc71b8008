"""The Python worker (child side).

Counterpart of ``spark_rapids_tpu/python_worker/worker.py``.  It speaks
length-prefixed Arrow IPC frames over stdin and stdout:

    parent -> child:  [u32 len][pickled sys.path]      (once)
                      [u32 len][pickled fn]            (once)
                      [u32 len][arrow IPC stream]...   (a batch each)
                      [u32 0]                          (shutdown)
    child  -> parent: [u32 len][arrow IPC stream]      (a batch each)
                      on error: [u32 0xFFFFFFFF][u32 len][utf-8 msg]

A user function that prints cannot break the framing: the child moves
the frame pipe to a private descriptor and points its stdout at
stderr.  It imports only pyarrow here, and what unpickling the function
imports.
"""

from __future__ import annotations

import os
import pickle
import struct
import sys

_ERR = 0xFFFFFFFF


def _read_exact(f, n: int) -> bytes:
    chunks = []
    while n:
        b = f.read(n)
        if not b:
            raise EOFError
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _frame(f) -> bytes:
    (n,) = struct.unpack("<I", _read_exact(f, 4))
    return _read_exact(f, n)


def main() -> int:
    import pyarrow as pa

    stdin = sys.stdin.buffer
    framing_fd = os.dup(sys.stdout.fileno())
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    sys.stdout = sys.stderr
    stdout = os.fdopen(framing_fd, "wb")
    for p in pickle.loads(_frame(stdin)):
        if p not in sys.path:
            sys.path.append(p)
    fn = pickle.loads(_frame(stdin))
    while True:
        (n,) = struct.unpack("<I", _read_exact(stdin, 4))
        if n == 0:
            return 0
        payload = _read_exact(stdin, n)
        try:
            out = fn(pa.ipc.open_stream(payload).read_all())
            if isinstance(out, pa.RecordBatch):
                out = pa.Table.from_batches([out])
            if not isinstance(out, pa.Table):
                raise TypeError("UDF must return a pyarrow Table/RecordBatch"
                                f", got {type(out).__name__}")
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, out.schema) as w:
                w.write_table(out)
            data = sink.getvalue().to_pybytes()
            stdout.write(struct.pack("<I", len(data)))
            stdout.write(data)
        except Exception as e:  # reported; the worker serves on
            msg = f"{type(e).__name__}: {e}".encode()
            stdout.write(struct.pack("<II", _ERR, len(msg)))
            stdout.write(msg)
        stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
