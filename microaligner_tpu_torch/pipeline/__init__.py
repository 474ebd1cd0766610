"""Pipeline stages of the port (counterpart of ``microaligner_tpu.pipeline``)."""
