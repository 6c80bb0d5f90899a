"""`python -m primestereomatch_torch ...`: the psm-torch command line."""

if __name__ == "__main__":
    from primestereomatch_torch.cli import main

    raise SystemExit(main())
