"""LLM serving on the port: ``serve.llm`` (``build_model``,
``build_spec_draft``, ``LLMServer``), ``serve.llm_pool`` (``PrefillWorker``)
and ``serve.hooks`` (the runtime calls, injected). Mirrors ray_tpu/serve's
llm.py and llm_pool.py. The submodules are imported by name: the decode
engine imports ``serve.hooks``, so this package imports nothing itself."""
