"""Continual train-while-serve (counterpart of ``cxxnet_tpu/continual/``).

``task = continual`` composes the trainer, the checkpoint writer,
sealed-bundle export (``artifact/bundle.py``) and the fleet front end
with its hot-swap watcher (``serve/frontend.py``, ``serve/swap.py``)
into one long-lived process: train on a looping iterator while the
fleet serves live traffic, and every ``continual_export_every`` updates
run the generation pipeline (eval gate -> verified snapshot -> sealed
bundle -> watcher ``notify()`` -> flip), for N generations.
"""

from .loop import ContinualConfig, ContinualLoop, GenerationExporter

__all__ = ["ContinualConfig", "ContinualLoop", "GenerationExporter"]
