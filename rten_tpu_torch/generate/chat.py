"""Chat-message rendering for the /v1/chat/completions endpoint.

The reference's chat example hard-codes one prompt format
(rten-examples/src/qwen2_chat.rs); serving needs a pluggable template:
``render_chat(messages, template)`` where ``template`` is a built-in name
or any callable ``messages -> str``.

Built-ins cover the common open-model families:

* ``zephyr`` — TinyLlama/Zephyr: ``<|role|>\\n{content}</s>`` turns,
  generation primed with ``<|assistant|>\\n``;
* ``chatml`` — Qwen/ChatML: ``<|im_start|>role\\n{content}<|im_end|>``;
* ``plain`` — ``role: content`` lines (debugging / untemplated models).


A copy of ``rten_tpu/generate/chat.py`` (pure Python)."""

from __future__ import annotations


def _check(messages):
    if not isinstance(messages, list) or not messages:
        raise ValueError("messages must be a non-empty list")
    for m in messages:
        if not isinstance(m, dict) or "role" not in m or "content" not in m:
            raise ValueError("each message needs 'role' and 'content'")
        if m["role"] not in ("system", "user", "assistant"):
            raise ValueError(f"unknown role {m['role']!r}")


def _zephyr(messages):
    parts = [f"<|{m['role']}|>\n{m['content']}</s>\n" for m in messages]
    return "".join(parts) + "<|assistant|>\n"


def _chatml(messages):
    parts = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
             for m in messages]
    return "".join(parts) + "<|im_start|>assistant\n"


def _plain(messages):
    parts = [f"{m['role']}: {m['content']}\n" for m in messages]
    return "".join(parts) + "assistant: "


TEMPLATES = {"zephyr": _zephyr, "chatml": _chatml, "plain": _plain}


def render_chat(messages, template="plain") -> str:
    """Render OpenAI-style ``messages`` into a single prompt string."""
    _check(messages)
    fn = TEMPLATES.get(template, template)
    if not callable(fn):
        raise ValueError(f"unknown chat template {template!r} "
                         f"(built-ins: {sorted(TEMPLATES)})")
    return fn(messages)
