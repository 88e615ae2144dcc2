"""Data-parallel runs over devices and processes: mesh.py (device lists,
the gloo process group), train_step.py (the sharded basic training step),
ntc_step.py (the sharded NTC training step)."""
