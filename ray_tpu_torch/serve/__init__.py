"""Serving of the port (counterpart of ray_tpu/serve/); so far the LLM
engine and servers of `serve.llm` and the request deadline of
`serve.context`."""
