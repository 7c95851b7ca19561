"""Training runtime: engine, optimizers, schedules, loss scaling, remat."""
