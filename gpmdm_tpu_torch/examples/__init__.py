"""The JAX package's example scripts (``examples/*.py``, the scripted form of
the reference's notebooks) on the port.  Each runs as
``python -m gpmdm_tpu_torch.examples.<name>`` with the JAX script's flags and
printed lines, and has ``main(argv=None)``.  A script that runs a model does
so on the CUDA card unless ``GPMDM_TPU_PLATFORM=cpu``, and exits 2 without a
card and without that pin, as the command line does."""
