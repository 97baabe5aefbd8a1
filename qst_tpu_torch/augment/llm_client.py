"""OpenAI-compatible chat client for partially-positive synthesis — a host
copy of ``qst_tpu/augment/llm_client.py`` (``tests/test_torch_augment.py``
holds it to its source).

The reference's ``chatgpt`` strategy calls the OpenAI ChatCompletion API with
gpt-3.5-turbo (reference partially_positive_examples_selection.py:195-212).
This is the TPU-framework equivalent: a dependency-free (stdlib urllib) HTTP
client speaking the OpenAI chat-completions protocol against ANY compatible
endpoint (OpenAI itself, a local vLLM/llama.cpp server, a proxy), gated
behind environment variables so the canned mock stays the default in
zero-egress environments:

- ``QST_LLM_BASE_URL``  e.g. ``https://api.openai.com/v1`` or
  ``http://localhost:8000/v1`` (required to activate)
- ``QST_LLM_API_KEY``   bearer token (optional — local servers often skip it)
- ``QST_LLM_MODEL``     default ``gpt-3.5-turbo`` (the reference's model)

Usage: ``llm_fn = get_llm_fn()`` → pass to
``get_part_pos_examples(..., algorithm_type=LLM, llm_fn=llm_fn)``;
``get_llm_fn()`` returns None when the env gate is closed, which leaves the
mock fallback in charge (reference :237-238).
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

logger = logging.getLogger("qst_tpu_torch.llm_client")

BASE_URL_ENV = "QST_LLM_BASE_URL"
API_KEY_ENV = "QST_LLM_API_KEY"
MODEL_ENV = "QST_LLM_MODEL"
DEFAULT_MODEL = "gpt-3.5-turbo"  # reference :199


class OpenAICompatibleClient:
    """Minimal chat-completions client; ``__call__(prompt) -> str`` matches
    the ``llm_fn`` interface of ``get_part_pos_examples``."""

    def __init__(self, base_url: str, api_key: str = "",
                 model: str = DEFAULT_MODEL, temperature: float = 1.0,
                 timeout: float = 60.0, max_retries: int = 3):
        if not base_url:
            raise ValueError("base_url is required")
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model = model
        self.temperature = temperature
        self.timeout = timeout
        self.max_retries = max_retries

    def __call__(self, prompt: str) -> str:
        payload = json.dumps({
            "model": self.model,
            "temperature": self.temperature,
            "messages": [{"role": "user", "content": prompt}],
        }).encode()
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        url = f"{self.base_url}/chat/completions"
        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                req = urllib.request.Request(url, data=payload,
                                             headers=headers, method="POST")
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    body = json.loads(r.read().decode())
                return body["choices"][0]["message"]["content"]
            except (urllib.error.URLError, KeyError, ValueError,
                    json.JSONDecodeError) as e:
                last_err = e
                logger.warning("LLM request failed (attempt %d/%d): %s",
                               attempt + 1, self.max_retries, e)
                if attempt + 1 < self.max_retries:
                    time.sleep(min(2.0 ** attempt, 8.0))
        raise RuntimeError(
            f"LLM request to {url} failed after {self.max_retries} "
            f"attempts") from last_err


def get_llm_fn(base_url: Optional[str] = None,
               api_key: Optional[str] = None,
               model: Optional[str] = None,
               **kw) -> Optional[Callable[[str], str]]:
    """Env-gated factory: a real client when ``QST_LLM_BASE_URL`` (or the
    explicit ``base_url``) is set, else None → callers keep the canned mock
    (reference mock_llm_response fallback, :23-26,:237-238)."""
    base_url = base_url or os.environ.get(BASE_URL_ENV, "")
    if not base_url:
        return None
    return OpenAICompatibleClient(
        base_url,
        api_key=api_key if api_key is not None
        else os.environ.get(API_KEY_ENV, ""),
        model=model or os.environ.get(MODEL_ENV, DEFAULT_MODEL),
        **kw)
