"""``python -m tpu_mpi_torch.lint file.py dir/ …`` — the static communication
lint CLI (docs/analysis.md). Thin shim over :mod:`tpu_mpi_torch.analyze.lint`."""

from .analyze.lint import lint_paths, lint_source, main

__all__ = ["lint_paths", "lint_source", "main"]

if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
