"""GPT-4 judge, absolute scoring protocol; the port's own copy of
``seed_story_tpu/eval/gpt_score_eval.py``.

It scores style consistency / engagingness / text-image coherence out of
10 over the first 5 segments of each generated story folder
(val_0..val_179), with the reference's judge instructions, ``[[N]]``
extraction and retry-3x API wrapper.

The OpenAI client is injected, or built from OPENAI_BASE_URL /
OPENAI_API_KEY by ``default_client`` (the only place ``openai`` is
imported), so the protocol is testable offline with a fake client.
"""

from __future__ import annotations

import base64
import os
import re
import time
from typing import Callable, Dict, List, Optional

STYLE_INSTRUCTION = (
    "Please act as an impartial judge and evaluate the quality of the "
    "generation story contents provided by an AI assistant. Your job is to "
    "give a score out of 10. Your evaluation should consider the style "
    "consistency of the story images. Do not allow the length of the "
    "responses to influence your evaluation. Be as objective as possible. "
    "After providing your explanation, output your final score by strictly "
    'following this format: "[[score]]", such as "[[7]]".'
)
ENGAGE_INSTRUCTION = STYLE_INSTRUCTION.replace(
    "the style consistency of the story images", "the engaging level of the story"
)
COHERENCE_INSTRUCTION = STYLE_INSTRUCTION.replace(
    "the style consistency of the story images",
    "the coherence of the generated story images and text",
)

METRICS = {
    "style": STYLE_INSTRUCTION,
    "engaging": ENGAGE_INSTRUCTION,
    "coherence": COHERENCE_INSTRUCTION,
}


def default_client():
    from openai import OpenAI  # optional dep; tests inject a fake

    return OpenAI(
        base_url=os.environ.get("OPENAI_BASE_URL"),
        api_key=os.environ.get("OPENAI_API_KEY"),
    )


def api_call(client, messages, model="gpt-4-turbo-2024-04-09",
             max_tokens=4096, temperature=0.3, retries=3, backoff=15.0):
    """Retry-3x wrapper (reference :23-46)."""
    for attempt in range(retries):
        try:
            out = client.chat.completions.create(
                messages=messages, model=model,
                max_tokens=max_tokens, temperature=temperature,
            )
            return out.choices[0].message.content.strip()
        except Exception as e:  # noqa: BLE001 — mirror reference behavior
            print(f"Error during API call: {e}")
            time.sleep(backoff)
    return None


def encode_image(image_path: str) -> str:
    with open(image_path, "rb") as f:
        return base64.b64encode(f.read()).decode("utf-8")


def find_number_in_string(text: Optional[str]) -> Optional[int]:
    """Extract the [[N]] verdict (reference :180-195)."""
    if text is None:
        return None
    match = re.search(r"\[\[(\d+)\]\]", text)
    return int(match.group(1)) if match else None


def read_story_folders(base_path: str, n_folders: int = 180,
                       max_sentences: int = 6, max_images: int = 6
                       ) -> List[Dict]:
    """val_{i} folders -> {'sentences': [...], 'images': [...]} (ref :80-117)."""
    contents = []
    for i in range(n_folders):
        folder = os.path.join(base_path, f"val_{i}")
        if not os.path.isdir(folder):
            continue
        entry = {"sentences": [], "images": []}
        text_path = os.path.join(folder, "text.txt")
        if os.path.isfile(text_path):
            with open(text_path) as f:
                entry["sentences"] = [
                    s.replace("[INST]", "") for s in f.read().splitlines()[:max_sentences]
                ]
        for j in range(1, max_images + 1):
            p = os.path.join(folder, f"ori_0{j}.jpg")
            if os.path.isfile(p):
                entry["images"].append(p)
        if entry["sentences"] or entry["images"]:
            contents.append(entry)
    return contents


def build_messages(story: Dict, instruction: str, max_judged: int = 5) -> List[Dict]:
    """The judge conversation: instruction + interleaved sentences/images."""
    content = [{"type": "text", "text": instruction}]
    for i, sent in enumerate(story["sentences"][:max_judged]):
        content.append({"type": "text", "text": f"Segment {i + 1}: {sent}"})
        if i < len(story["images"][:max_judged]):
            content.append({
                "type": "image_url",
                "image_url": {
                    "url": "data:image/jpeg;base64,"
                    + encode_image(story["images"][i])
                },
            })
    return [{"role": "user", "content": content}]


def evaluate_folder(base_path: str, client=None, out_dir: str = ".",
                    model: str = "gpt-4-turbo-2024-04-09") -> Dict[str, float]:
    """Full protocol: 3 metrics x all stories -> result_{metric}.txt files +
    returned averages (reference main(), :196-221)."""
    client = client or default_client()
    stories = read_story_folders(base_path)
    averages = {}
    for metric, instruction in METRICS.items():
        total, scores = 0, ""
        n = 0
        for story in stories:
            judgment = api_call(client, build_messages(story, instruction),
                                model=model)
            score = find_number_in_string(judgment)
            scores += f"{score}\n"
            if score is not None:
                total += score
                n += 1
        avg = total / max(n, 1)
        averages[metric] = avg
        with open(os.path.join(out_dir, f"result_{metric}.txt"), "w") as f:
            f.write(f"total:{total}\navg:{avg}\nscores:{scores}")
    return averages


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--stories", required=True, help="dir with val_* folders")
    p.add_argument("--out_dir", default=".")
    p.add_argument("--model", default="gpt-4-turbo-2024-04-09")
    a = p.parse_args()
    print(evaluate_folder(a.stories, out_dir=a.out_dir, model=a.model))
