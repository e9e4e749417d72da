"""One driver per entry of the program that a window drives: ``run(ctx)``
makes the set-up, runs the window, optionally the traced phase, and the
comparison with the reference."""
