"""`python -m primestereomatch_torch.launch`: the alias of parallel.launch.

Import-safe: the package's module walk imports it, so `main()` runs only
under `__main__`."""

from primestereomatch_torch.parallel.launch import (  # noqa: F401
    initialize,
    main,
    spawn_local,
    worker_main,
)

if __name__ == "__main__":
    import sys

    sys.exit(main())
