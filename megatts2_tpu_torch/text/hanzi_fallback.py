"""Minimal vendored hanzi → TONE3-pinyin table (pypinyin fallback).

The reference's Chinese front-end needs pypinyin (its
``modules/tokenizer.py:65-72``); some deployments lack it, which would
leave the hanzi G2P branch without a path and untested.  This table covers
~100 common characters with their single most-frequent reading in
pypinyin's ``Style.TONE3, neutral_tone_with_five=True`` convention
(neutral tone = '5'), enough to exercise the full hanzi → pinyin → MFA
phone pipeline end-to-end.

Resolution order in the tokenizer: pypinyin when installed (contextual,
full coverage) → this table per character → RuntimeError for uncovered
characters.  Per-character lookup cannot resolve polyphones from context,
so the table only lists characters whose dominant single-character reading
is unambiguous.
"""
from __future__ import annotations

from typing import Dict

HANZI_TONE3: Dict[str, str] = {
    # pronouns / particles
    "你": "ni3", "我": "wo3", "他": "ta1", "她": "ta1", "它": "ta1",
    "们": "men5", "的": "de5", "吗": "ma5", "呢": "ne5", "吧": "ba5",
    # common verbs / adjectives
    "是": "shi4", "有": "you3", "在": "zai4", "爱": "ai4", "说": "shuo1",
    "听": "ting1", "看": "kan4", "读": "du2", "写": "xie3", "来": "lai2",
    "去": "qu4", "回": "hui2", "出": "chu1", "入": "ru4", "开": "kai1",
    "关": "guan1", "走": "zou3", "飞": "fei1", "喜": "xi3", "欢": "huan1",
    "好": "hao3", "高": "gao1", "低": "di1", "快": "kuai4", "慢": "man4",
    "新": "xin1", "多": "duo1", "很": "hen3", "大": "da4", "小": "xiao3",
    # nouns
    "人": "ren2", "天": "tian1", "气": "qi4", "山": "shan1", "水": "shui3",
    "火": "huo3", "口": "kou3", "日": "ri4", "月": "yue4", "年": "nian2",
    "明": "ming2", "早": "zao3", "晚": "wan3", "安": "an1", "学": "xue2",
    "生": "sheng1", "老": "lao3", "师": "shi1", "同": "tong2", "家": "jia1",
    "工": "gong1", "作": "zuo4", "门": "men2", "车": "che1", "电": "dian4",
    "脑": "nao3", "手": "shou3", "机": "ji1", "语": "yu3", "音": "yin1",
    "声": "sheng1", "话": "hua4", "文": "wen2", "字": "zi4", "风": "feng1",
    "云": "yun2", "花": "hua1", "草": "cao3", "树": "shu4", "鸟": "niao3",
    "鱼": "yu2", "马": "ma3", "牛": "niu2", "羊": "yang2", "狗": "gou3",
    "猫": "mao1", "妈": "ma1", "爸": "ba4", "世": "shi4", "界": "jie4",
    "中": "zhong1", "国": "guo2", "京": "jing1", "北": "bei3", "南": "nan2",
    "东": "dong1", "西": "xi1", "上": "shang4", "下": "xia4",
    # colors
    "白": "bai2", "黑": "hei1", "红": "hong2",
    # numbers
    "一": "yi1", "二": "er4", "三": "san1", "四": "si4", "五": "wu3",
    "六": "liu4", "七": "qi1", "八": "ba1", "九": "jiu3", "十": "shi2",
    "百": "bai3", "千": "qian1", "万": "wan4", "零": "ling2",
    # courtesy
    "谢": "xie4", "再": "zai4", "见": "jian4", "请": "qing3",
}
