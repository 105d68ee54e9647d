"""Totoro+ core: the numpy control plane (overlay, forest, recovery),
copied from ``repro.core``, and the Table-II API on tensors."""
