SELECT "SearchPhrase", MIN("URL") AS mn, MIN("Title") AS mt, COUNT(*) AS c,
       COUNT(DISTINCT "UserID") AS u
FROM hits
WHERE "Title" LIKE '%Google%' AND "URL" NOT LIKE '%.google.%'
  AND "SearchPhrase" <> ''
GROUP BY "SearchPhrase" ORDER BY c DESC LIMIT 10
