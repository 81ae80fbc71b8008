"""Frontends: plan surfaces lowered onto the port's DataFrame API.

``sql`` runs SQL text (``SqlSession``); ``substrait`` runs Substrait
plans (``SubstraitFrontend``), and registers itself with the plugin as
``substrait``.
"""
