"""One module a model family, ``families/<model_type>.py``, found by the
``model_type`` of a configuration file: ``model_config(c, name)`` (the
program's ``ModelConfig``), ``kv_bytes_per_token(c)`` and
``active_flops(params, c)``.  Its plain reference is
``reference/<model_type>.py``."""
