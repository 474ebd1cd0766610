"""Optical-flow registration engine (counterpart of ``microaligner_tpu.optflow``)."""
