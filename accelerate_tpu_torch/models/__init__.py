"""Models of the port: the Llama-recipe decoder and batched sampling."""
