"""Serving of the port (counterpart of ray_tpu/serve/); so far the LLM
engine and server of `serve.llm`."""
