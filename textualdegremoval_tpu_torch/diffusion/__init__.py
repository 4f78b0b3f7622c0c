"""Pipeline A of the port: DDIM sampling, the tokenizer and generation."""
