"""The wire front door: plans submitted over TCP by another process.

Counterpart of ``spark_rapids_tpu/connect/`` (a Spark Connect-style
ingress): a client process serializes a plan, Substrait (JSON or its
dict) or SQL text, with conf overrides, SQL parameter bindings, a tenant
and an optional deadline, and sends it to a server, which runs it
through the serving tier (admission, the prepared-plan cache, the
result and scan caches, cancellation and deadlines) and streams the
result back as Arrow IPC frames, one a batch, backpressured by the
socket.

- ``connect/server.py``: ``ConnectServer``, a ``ThreadingTCPServer`` over
  the port's sessions;
- ``connect/client.py``: ``ConnectClient``, stdlib and pyarrow only: a
  client process imports no torch and no engine module;
- ``python -m spark_rapids_tpu_torch.tools.connect_client``: the client
  as a command.

The frames are the JAX package's, byte for byte, so either package's
client talks to either's server.  The keys are in ``config.py``
(``spark.rapids.tpu.connect.*``).  No authentication: the server binds
the loopback address unless told otherwise.
"""
