"""GPT-4 judge, pairwise A/B protocol; the port's own copy of
``seed_story_tpu/eval/gpt_comparative_eval.py``.

The judge sees two assistants' story segments and returns [[A]] / [[B]] /
[[C]] (tie); verdicts are tallied into win rates per dimension (style,
engaging and coherence are all selectable).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from .gpt_score_eval import api_call, build_messages, default_client, encode_image

_BASE = (
    "Please act as an impartial judge and evaluate the quality of the "
    "generation story contents provided by two AI assistants. Your job is "
    "to evaluate which assistant's generation is better. Your evaluation "
    "should consider {dimension}. Avoid any position biases and ensure "
    "that the order in which the responses were presented does not "
    "influence your decision. Do not allow the length of the responses to "
    "influence your evaluation. Do not favor certain names of the "
    "assistants. Be as objective as possible. After providing your "
    "explanation, output your final verdict by strictly following this "
    'format: "[[A]]" if assistant A is better, "[[B]]" if assistant B is '
    'better, and "[[C]]" for a tie.'
)

INSTRUCTIONS = {
    "coherence": _BASE.format(
        dimension="the coherence of the generated story images and text"),
    "style": _BASE.format(dimension="the style consistency of the story images"),
    "engaging": _BASE.format(dimension="the engaging level of the story"),
}


def build_pair_messages(story_a: Dict, story_b: Dict, instruction: str,
                        max_judged: int = 5) -> List[Dict]:
    content = [{"type": "text", "text": instruction}]
    for label, story in (("A", story_a), ("B", story_b)):
        content.append({"type": "text", "text": f"[Assistant {label}'s story]"})
        for i, sent in enumerate(story["sentences"][:max_judged]):
            content.append({"type": "text", "text": f"Segment {i + 1}: {sent}"})
            if i < len(story["images"][:max_judged]):
                content.append({
                    "type": "image_url",
                    "image_url": {"url": "data:image/jpeg;base64,"
                                  + encode_image(story["images"][i])},
                })
    return [{"role": "user", "content": content}]


def compare(stories_a: List[Dict], stories_b: List[Dict],
            dimension: str = "coherence", client=None,
            model: str = "gpt-4-turbo-2024-04-09",
            out_path: Optional[str] = None) -> Dict[str, int]:
    """Returns {'a_win', 'b_win', 'tie', 'error'} tallies (ref :222-247)."""
    client = client or default_client()
    assert len(stories_a) == len(stories_b)
    instruction = INSTRUCTIONS[dimension]
    a_win = b_win = tie = 0
    errors = []
    for i, (a, b) in enumerate(zip(stories_a, stories_b)):
        judgment = api_call(client, build_pair_messages(a, b, instruction),
                            model=model) or ""
        if "[[A]]" in judgment:
            a_win += 1
        elif "[[B]]" in judgment:
            b_win += 1
        elif "[[C]]" in judgment:
            tie += 1
        else:
            errors.append([i, judgment])
    result = {"a_win": a_win, "b_win": b_win, "tie": tie, "error": len(errors)}
    if out_path:
        with open(out_path, "w") as f:
            f.write(f"a:{a_win}\nb:{b_win}\ntie:{tie}\nerror:{errors}")
    return result


if __name__ == "__main__":
    import argparse

    from .gpt_score_eval import read_story_folders

    p = argparse.ArgumentParser()
    p.add_argument("--stories_a", required=True)
    p.add_argument("--stories_b", required=True)
    p.add_argument("--dimension", default="coherence",
                   choices=list(INSTRUCTIONS))
    p.add_argument("--out", default=None)
    a = p.parse_args()
    print(compare(read_story_folders(a.stories_a),
                  read_story_folders(a.stories_b),
                  a.dimension, out_path=a.out))
