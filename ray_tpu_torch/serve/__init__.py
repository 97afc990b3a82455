"""LLM serving on the port: ``serve.llm`` (``build_model``,
``build_spec_draft``, ``LLMServer``), ``serve.llm_pool`` (``LLMPool``,
``PrefillWorker``, ``run_llm_pool``), ``serve.runtime`` (the members'
runtime: ``InProcessRuntime``), ``serve.process_runtime``
(``ProcessRuntime``: members in processes of their own) and
``serve.hooks`` (the runtime calls, injected). Mirrors ray_tpu/serve's
llm.py and llm_pool.py. The decode
engine imports ``serve.hooks``, so this package imports no submodule when
it is imported: ``run_llm_pool`` is loaded on first use."""


def __getattr__(name):
    if name == "run_llm_pool":
        from ray_tpu_torch.serve.llm_pool import run_llm_pool

        return run_llm_pool
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
