"""Entry points of the port: ``launch.serve`` (the language model's
decode loop ``ServeLoop`` and its ``main``, and the measured serving
engine over the tiered paged-KV cache), ``launch.train`` (the training
driver and its ``main``) and ``launch.steps`` (the step builders)."""
