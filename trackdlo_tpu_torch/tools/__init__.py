"""Operator tooling of the port: :mod:`serve`, the TCP tracker service and
its replay client (counterpart of trackdlo_tpu/tools/serve.py)."""
