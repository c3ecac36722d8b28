"""repro_torch.examples — the port's twins of the JAX package's example
drivers (``examples/*.py`` at the root of the repository).

Each module keeps its twin's workload, sizes, flags and checks, runs on
CUDA unless ``--device cpu`` is given (and raises without a CUDA device),
and has a ``run(...)`` that takes its inputs and returns the observables
it prints, and a ``main(argv)`` that prints them, asserts the checks and
ends with ``"<name> OK"``:

    PYTHONPATH=src python -m repro_torch.examples.linear_scaling_dft
    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.tensor_contraction
    PYTHONPATH=src python -m repro_torch.examples.serve_batch
    PYTHONPATH=src python -m repro_torch.examples.train_lm

The meshes are meshes of ranks (``launch.mesh``), every rank on the one
device, so no fake devices are set up.
"""
