"""Frontends: plan surfaces lowered onto the port's DataFrame API.

``sql`` runs SQL text (``SqlSession``).  The JAX package's plugin
registry and its Substrait frontend are not ported.
"""
