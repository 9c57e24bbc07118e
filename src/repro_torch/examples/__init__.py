"""The system's entry points on the port (``examples/*.py`` of the JAX
package, module for module). Each runs as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

with the JAX example's own flags plus ``--device {cuda,cpu}`` (default
``cuda``; without a card it raises), prints the JAX example's lines, and
has a ``main(argv=None)`` that returns a dict of what it printed: the
lines themselves (``"lines"``) and the numbers behind them. The sizes the
JAX examples fix in their bodies are module constants or keyword
arguments of a factored function here, with the JAX values as defaults.

Modules: ``quickstart``, ``batched_server_decode``, ``fl_serve``,
``fl_async_sampling``, ``ae_lifecycle_refresh``, ``per_layer_partitions``,
``adaptive_rate_control``, ``fl_color_imbalance``, ``llm_federated``,
``llm_serve_decode``.
"""
NAMES = ("quickstart", "batched_server_decode", "fl_serve",
         "fl_async_sampling", "ae_lifecycle_refresh", "per_layer_partitions",
         "adaptive_rate_control", "fl_color_imbalance", "llm_federated",
         "llm_serve_decode")
