"""Command-line interface: ``flowreg3d`` console script."""
